"""zeebe_tpu_torch — the PyTorch and CUDA port of zeebe_tpu's device path.

The package mirrors ``zeebe_tpu``'s layout so each counterpart sits under the
same path, and imports neither JAX nor anything of ``zeebe_tpu``: the host
modules the device path needs (BPMN model, FEEL parser, deploy-time table
compiler, element enums) are kept as copies here.

Layer map:

- ``protocol.enums``      BPMN element/event types (the opcode table keys)
- ``feel``                FEEL-lite parser (condition ASTs for the compiler)
- ``models.bpmn``         fluent builder, XML I/O, deploy-time transformer
- ``ops.tables``          deploy-time tables: opcodes, flows, condition programs
- ``ops.automaton``       the lock-step automaton: plain PyTorch versions and
                          the wrappers that launch the CUDA kernels
- ``ops.kernels``         build (nvcc, sm_90a) and ctypes binding of
                          ``csrc/automaton.cu``
- ``ops.parity``          step-event decoding into per-instance intents
- ``engine.eligibility``  element and definition eligibility reasons (copy)
- ``engine.kernel_backend``  the registry (shared table set per partition,
                          call/MI inlining, content fingerprint; copied) and
                          the device half of the serving path: group arrays,
                          chunked runs with prefetch, instance traces, and
                          partitions driven through a shared mesh runner
- ``parallel.mesh``       partitions as shard blocks of one card's batch:
                          the sharded step and its plain version
- ``parallel.mesh_runner``  N partitions' groups in one sharded dispatch
- ``testing.catalog``     an in-memory deployed-process catalog
- ``utils.metrics``       the metrics registry (copy)

Entry points take ``device=None``, meaning ``"cuda"``; they raise when CUDA
is missing unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
