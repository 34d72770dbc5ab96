"""zeebe_tpu_torch — the PyTorch and CUDA port of zeebe_tpu's device path.

The package mirrors ``zeebe_tpu``'s layout so each counterpart sits under the
same path, and imports neither JAX nor anything of ``zeebe_tpu``: the host
modules the device path needs (BPMN model, FEEL parser, deploy-time table
compiler, element enums) are kept as copies here.

Layer map of this slice:

- ``protocol.enums``      BPMN element/event types (the opcode table keys)
- ``feel``                FEEL-lite parser (condition ASTs for the compiler)
- ``models.bpmn``         fluent builder, XML I/O, deploy-time transformer
- ``ops.tables``          deploy-time tables: opcodes, flows, condition programs
- ``ops.automaton``       the lock-step automaton: plain PyTorch versions and
                          the wrappers that launch the CUDA kernels
- ``ops.kernels``         build (nvcc, sm_90a) and ctypes binding of
                          ``csrc/automaton.cu``
- ``ops.parity``          step-event decoding into per-instance intents
- ``engine.kernel_backend``  the device half of the serving path: group
                          arrays, chunked runs with prefetch, instance traces

Entry points take ``device=None``, meaning ``"cuda"``; they raise when CUDA
is missing unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
