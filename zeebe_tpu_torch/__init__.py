"""zeebe_tpu_torch — the PyTorch and CUDA port of zeebe_tpu.

The package mirrors ``zeebe_tpu``'s layout so each counterpart sits under the
same path, and imports neither JAX nor anything of ``zeebe_tpu``: the host
modules it needs (protocol, engine stack, BPMN model, FEEL parser,
deploy-time table compiler) are kept as copies here
(``testing/copies.py`` writes the engine stack's).

Layer map, from the client down (copies unless noted):

- ``client``              ``ZeebeTpuClient``, ``JobWorker``, credentials
- ``gateway``             the gRPC front: ``Gateway``, ``GatewayService``,
                          tenant authorization, OAuth, admission; and
                          ``ClusterRuntime`` (partial copy: the kernel
                          backend's ``device``)
- ``broker``, ``cluster``, ``control``  brokers and partitions (partial
                          copies: ``device``), Raft, membership, topology,
                          the control plane
- ``testing``             ``EngineHarness``, ``MultiPartitionHarness``,
                          ``ControlledClock`` (rewritten: the kernel
                          backend's ``device``)
- ``stream``              the stream processor (processing and replay)
- ``engine``              ``Engine``, state, appliers, BPMN processors,
                          timers, messages, signals, distribution
- ``logstreams``, ``journal``  the record log on a segmented journal
- ``state``               the transactional key-value state (in memory and
                          durable), snapshots, tiering
- ``exporters``, ``backup``, ``parallel.partitioning``, ``utils``
- ``observability``       tracing, metrics history, flight recorder,
                          alerts; ``profiler``'s device half on
                          ``torch.cuda`` (rewritten)
- ``protocol``            records, intents, keys, msgpack, enums
- ``native``              the C record codec, built with gcc at first use

The device path:

- ``feel``                FEEL-lite parser (condition ASTs for the compiler)
- ``models.bpmn``         fluent builder, XML I/O, deploy-time transformer
- ``ops.tables``          deploy-time tables: opcodes, flows, condition programs
- ``ops.automaton``       the lock-step automaton: plain PyTorch versions and
                          the wrappers that launch the CUDA kernels
- ``ops.kernels``         build (nvcc, sm_90a) and ctypes binding of
                          ``csrc/automaton.cu`` and ``csrc/decision.cu``
- ``ops.parity``          step-event decoding into per-instance intents
- ``ops.decision``        DMN decision tables compiled to atom arrays (host
                          compiler copied) and batch-evaluated: the plain
                          version and the wrapper of the decision kernel
- ``dmn``                 the host DMN evaluator (copy)
- ``engine.eligibility``  element and definition eligibility reasons (copy)
- ``engine.kernel_backend``  ``KernelBackend``, the serving write path:
                          admission, group build, route traces and
                          materialization (copied), the registry (shared
                          table set per partition, call/MI inlining, content
                          fingerprint; copied), and the device half: chunked
                          runs with prefetch, partitions driven through a
                          shared mesh runner, and the device-fault seam
                          (watchdog, chaos hooks, containment, sampled
                          shadow verification)
- ``engine.device_health``  the device health ladder (copy)
- ``control.audit``       the control_adjust audit record (copy)
- ``testing.chaos_device``, ``testing.chaos_common``  seeded device chaos
                          (copies)
- ``parallel.mesh``       partitions as shard blocks of one card's batch:
                          the sharded step and its plain version
- ``parallel.mesh_runner``  N partitions' groups in one sharded dispatch
- ``testing.catalog``     an in-memory deployed-process catalog
- ``utils.metrics``       the metrics registry (copy)

Entry points take ``device=None``, meaning ``"cuda"``; they raise when CUDA
is missing unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
