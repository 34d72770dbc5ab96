"""Env-knob inventory: every ``ZEEBE_*`` environment variable the port's
tree reads, found by AST scan — the source for ``cli knobs-doc`` and its
drift gate (the metrics-doc ``--check`` pattern applied to configuration).

Collection is literal-based, not call-based, on purpose: the broker binds
env vars through a declarative ``_ENV_BINDINGS`` table and the exporter
loader scans ``os.environ`` by prefix, so "calls to os.environ.get" would
miss half the real surface. Instead every string constant matching
``ZEEBE_[A-Z0-9_]+`` inside ``zeebe_tpu_torch/`` counts as a knob mention;
names ending in ``_`` are prefix *families* (``ZEEBE_BROKER_EXPORTERS_<ID>_…``),
and full names extending a known family fold into it as examples.

Every knob MUST have a one-line description in ``KNOB_NOTES`` —
``cli knobs-doc --check`` fails on a missing note (undocumented knob) or on
drift between the generated table and the committed
``zeebe_tpu_torch/docs/knobs.md``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

# copied from the reference: _KNOB_RE .. _KNOB_RE
_KNOB_RE = re.compile(r"^ZEEBE_[A-Z0-9_]+$")
# end of the copy

#: the curated one-liners — the human half of the generated doc. A new env
#: read without an entry here fails `cli knobs-doc --check` (CI): config
#: knobs that exist only in the code ARE the drift this gate exists for.
KNOB_NOTES: dict[str, str] = {
    "ZEEBE_ALERT_RSSWATERMARKBYTES": (
        "RSS high-watermark (bytes) for the default memory alert rule; the "
        "scale soak tightens it to its budget"),
    "ZEEBE_AUDIT_CRCWINDOW": (
        "records per replica-CRC checkpoint window the online auditor "
        "publishes for cross-worker spot agreement (default 5000)"),
    "ZEEBE_AUDIT_ENABLED": (
        "enable the per-broker online auditor: invariant monitors, SLO "
        "burn-rate alerts, leak-trend detection (default true)"),
    "ZEEBE_AUDIT_FASTWINDOWMS": (
        "fast burn-rate window (ms, default 5m): pages only when BOTH "
        "windows burn — the multiwindow SRE alerting shape"),
    "ZEEBE_AUDIT_GOODPUTFLOOR": (
        "acked/terminal fraction below which a tick counts as bad toward "
        "the burn-rate budget (default 0.7)"),
    "ZEEBE_AUDIT_LEAKMINGROWTH": (
        "minimum relative growth over the leak window before a trend can "
        "latch a leak verdict (default 0.3 = +30%)"),
    "ZEEBE_AUDIT_LEAKMINSAMPLES": (
        "minimum samples before the leak-trend detector renders any "
        "verdict (default 24)"),
    "ZEEBE_AUDIT_LEAKWARMUPMS": (
        "hold-off after broker boot before resource series feed the leak "
        "detector — boot-era monotone climbs are genuine, not leaks "
        "(default 60s)"),
    "ZEEBE_AUDIT_LEAKWINDOWMS": (
        "sliding window (ms, default 10m) for the least-squares "
        "resource-trend leak detector"),
    "ZEEBE_AUDIT_QUARANTINEMAXMS": (
        "max time the device-health ladder may sit QUARANTINED before the "
        "auditor latches a quarantine_latch violation (default 10m)"),
    "ZEEBE_AUDIT_SLOP99MS": (
        "admission ack-p99 SLO bound (ms) feeding the burn-rate good/bad "
        "classification (default 5000)"),
    "ZEEBE_AUDIT_SLOTARGET": (
        "availability SLO target for burn-rate math, e.g. 0.999 = 0.1% "
        "error budget (default 0.999)"),
    "ZEEBE_AUDIT_SLOWWINDOWMS": (
        "slow burn-rate window (ms, default 1h); sustained-but-mild burns "
        "raise a ticket instead of a page"),
    "ZEEBE_AUDIT_TESTLEAK": (
        "test-only deliberate leak (`fd:25`, `ring:50`) for the fleet-day "
        "recall arm — the auditor MUST convict a worker running this; "
        "never enable outside a harness"),
    "ZEEBE_BROKER_BACKPRESSURE_ALGORITHM": (
        "ingress rate-limit algorithm: `vegas` (default) | `aimd` | `fixed`"),
    "ZEEBE_BROKER_BACKPRESSURE_ENABLED": (
        "enable the per-partition in-flight command limiter (default true)"),
    "ZEEBE_BROKER_CLUSTER_INITIALCONTACTPOINTS": (
        "comma-separated member ids forming the cluster"),
    "ZEEBE_BROKER_CLUSTER_NODEID": "this broker's member id",
    "ZEEBE_BROKER_CLUSTER_PARTITIONSCOUNT": "number of partitions (>= 1)",
    "ZEEBE_BROKER_CLUSTER_REPLICATIONFACTOR": (
        "Raft replication factor per partition (>= 1)"),
    "ZEEBE_BROKER_DATA_BACKUP": (
        "prefix family: remote backup store — `…_STORE=S3|GCS|NONE` plus "
        "per-store sub-keys (`…_S3_ENDPOINT`, `…_GCS_BUCKETNAME`, …; "
        "backup/__init__.py)"),
    "ZEEBE_BROKER_DATA_DISK_ENABLEMONITORING": (
        "enable free-disk monitoring / ingestion pause (default true)"),
    "ZEEBE_BROKER_DATA_DISK_MINFREEBYTES": (
        "pause ingestion below this free-space watermark (default 128MiB)"),
    "ZEEBE_BROKER_DATA_LOGFLUSHDELAYMS": (
        "raft journal group-commit pacing: 0 (default) = fsync before every "
        "ack; > 0 = defer the fsync up to this many ms with acks strictly "
        "AFTER the covering fsync (several appends share one fsync). The "
        "journal-flush controller's knob — its actuator owns runtime "
        "changes"),
    "ZEEBE_BROKER_DATA_LOGMAXUNFLUSHEDBYTES": (
        "raft journal group-commit byte bound: a deferred flush drains "
        "early once this many unfsynced bytes accumulate (default 1MiB)"),
    "ZEEBE_BROKER_DATA_RECOVERYBUDGETMS": (
        "recovery-time budget: slower recoveries fire the "
        "recovery_budget_exceeded alert; the snapshot scheduler adapts its "
        "cadence to keep projected replay debt under it (<= 0 disables)"),
    "ZEEBE_BROKER_DATA_SNAPSHOTCHAINLENGTH": (
        "incremental snapshots: base+delta chain length before a full "
        "rebase (1 = every snapshot full)"),
    "ZEEBE_BROKER_DATA_SNAPSHOTPERIOD": "periodic snapshot cadence (ms)",
    "ZEEBE_BROKER_DATA_SCRUB_ENABLED": (
        "at-rest storage scrubber: pump-throttled background CRC walk over "
        "journal bytes, snapshot chain files, and cold segments — bit rot "
        "is detected (and repaired) before a read serves it (default on)"),
    "ZEEBE_BROKER_DATA_SCRUB_INTERVALMS": (
        "scrubber: minimum ms between scrub slices on the pump "
        "(default 1000)"),
    "ZEEBE_BROKER_DATA_SCRUB_BYTESPERPASS": (
        "scrubber: byte budget re-CRCed per slice — bounds the pump stall "
        "per pass (default 4MiB)"),
    "ZEEBE_BROKER_DATA_TIERING_ENABLED": (
        "state tiering: spill parked instances to the cold disk store"),
    "ZEEBE_BROKER_DATA_TIERING_PARKAFTERMS": (
        "tiering: park an instance this long before it becomes a spill "
        "candidate"),
    "ZEEBE_BROKER_DATA_TIERING_SPILLBATCH": (
        "tiering: instances spilled per pump pass"),
    "ZEEBE_BROKER_DEVICE_DISPATCHTIMEOUTMS": (
        "device dispatch watchdog: a dispatch/fetch exceeding this deadline "
        "is contained as a typed wedge (0 disables; armed only on real "
        "accelerators or under device chaos — default 45000)"),
    "ZEEBE_BROKER_DEVICE_SHADOWSAMPLERATE": (
        "fraction of kernel groups re-executed on the host oracle and "
        "compared byte-for-byte before commit (silent-corruption "
        "detection; default 0.02)"),
    "ZEEBE_BROKER_DEVICE_SUSPECTSHADOWBOOST": (
        "shadow-sample-rate multiplier while the device health ladder is "
        "SUSPECT (default 8)"),
    "ZEEBE_BROKER_DEVICE_QUARANTINEFAULTS": (
        "device faults inside the fault window that escalate SUSPECT to "
        "QUARANTINED (default 3)"),
    "ZEEBE_BROKER_DEVICE_FAULTWINDOWMS": (
        "sliding window the quarantine fault count is evaluated over "
        "(default 60000)"),
    "ZEEBE_BROKER_DEVICE_SUSPECTCLEARMS": (
        "fault-free ms under boosted shadow sampling that steps SUSPECT "
        "back to HEALTHY (default 30000)"),
    "ZEEBE_BROKER_DEVICE_CANARYINTERVALMS": (
        "cadence of known-answer canary dispatches while QUARANTINED "
        "(default 5000)"),
    "ZEEBE_BROKER_DEVICE_CANARYSUCCESSES": (
        "consecutive verified canaries that re-prove a QUARANTINED device "
        "(default 2)"),
    "ZEEBE_BROKER_DEVICE_SHADOWSEED": (
        "seed of the deterministic shadow-sampling decision stream"),
    "ZEEBE_BROKER_EXPERIMENTAL_CONSISTENCYCHECKS": (
        "enable foreign-key consistency checks in the state store"),
    "ZEEBE_BROKER_EXPERIMENTAL_DURABLESTATE": (
        "enable the durable (WAL-backed) state store backend"),
    "ZEEBE_BROKER_EXPERIMENTAL_KERNELBACKEND": (
        "enable the CUDA automaton-kernel processing backend"),
    "ZEEBE_BROKER_EXPERIMENTAL_KERNELMESHSHARDS": (
        "kernel mesh shards: -1 auto (devices), 0 off, N explicit"),
    "ZEEBE_BROKER_METRICS_SAMPLINGINTERVALMS": (
        "registry→time-series sampling cadence (0 disables the store, "
        "sampler, and alert evaluation)"),
    "ZEEBE_BROKER_NETWORK_MAXOUTBOUNDBUFFERBYTES": (
        "zombie-client protection: per-stream outbound buffer bound — a "
        "connected peer that stops reading is disconnected once this many "
        "bytes buffer (default 8MiB)"),
    "ZEEBE_BROKER_NETWORK_SECURITY_CERTIFICATEAUTHORITYPATH": (
        "TLS: CA bundle path for cluster messaging"),
    "ZEEBE_BROKER_NETWORK_SECURITY_CERTIFICATECHAINPATH": (
        "TLS: certificate chain path for cluster messaging"),
    "ZEEBE_BROKER_NETWORK_SECURITY_ENABLED": (
        "TLS on the cluster messaging plane (default off)"),
    "ZEEBE_BROKER_NETWORK_SECURITY_PRIVATEKEYPATH": (
        "TLS: private key path for cluster messaging"),
    "ZEEBE_BROKER_PROCESSING_COALESCEWINDOWMS": (
        "worker ingress batch-coalescing window (ms): admitted client "
        "commands arriving within it append as ONE raft batch (one fsync, "
        "one replication round). 0 (default) = append per command; the "
        "ingress-coalescing controller's knob"),
    "ZEEBE_BROKER_PIPELINE_SPECULATION": (
        "cross-wave double-buffered dispatch: admit wave k+1 and dispatch "
        "its first device chunk inside wave k's transaction so the chunk "
        "computes under wave k's append/commit/fsync tail (default on; "
        "0/false/off disables)"),
    "ZEEBE_BROKER_PROCESSING_MAXCOMMANDSINBATCH": (
        "commands processed per batch transaction (default 100)"),
    "ZEEBE_BROKER_PROFILING_HZ": (
        "continuous profiler stack-sampling rate (0 disables the plane)"),
    "ZEEBE_BROKER_EXPORTERS_": (
        "prefix family: external exporter loading — "
        "`…_<ID>_CLASSNAME` / `…_<ID>_PATH` / `…_<ID>_ARGS_<K>` "
        "(utils/external_code.py)"),
    "ZEEBE_CHAOS_CRASH_AFTER_APPENDS": (
        "chaos seam: hard-exit the worker process between the Nth "
        "successful ingress append and its reply (one-shot per data dir; "
        "consistency gate)"),
    "ZEEBE_CHAOS_DISK": (
        "chaos disk: seeded storage fault-injection spec (write EIO/ENOSPC/"
        "torn rates, fsync stall/failure rates, at-rest bit-rot cadence, "
        "path classes) installed into the utils/storage_io seam; the "
        "torture gate's fault source"),
    "ZEEBE_CHAOS_DISK_DISARMFILE": (
        "chaos disk: path the controller polls each tick — creating it "
        "disarms all disk faults (the torture harness ends the survival "
        "window before its probe/quiesce phases)"),
    "ZEEBE_CHAOS_DEVICE": (
        "chaos device: seeded accelerator fault-injection spec (compile/"
        "dispatch failure, stall, partial-chunk failure, result bit-flip "
        "rates) installed into the kernel dispatch seam; the device-chaos "
        "gate's fault source"),
    "ZEEBE_CHAOS_DEVICE_DISARMFILE": (
        "chaos device: path the controller polls each tick — creating it "
        "disarms all device faults (the gate's recovery phase lets the "
        "canary ladder re-prove an honest device)"),
    "ZEEBE_CHAOS_EPOCH_MS": (
        "chaos TCP: epoch anchor for deterministic link-partition windows "
        "across processes"),
    "ZEEBE_CHAOS_TCP": (
        "chaos TCP: seeded fault-injection spec (drop/dup/delay/reorder "
        "rates + seed) wrapped around a process's messaging plane"),
    "ZEEBE_CHAOS_TCP_WINDOWSFILE": (
        "chaos TCP: JSON file of link-partition windows the wrapper "
        "enforces"),
    "ZEEBE_CLIENT_ID": "OAuth client id for gateway client credentials",
    "ZEEBE_CLIENT_SECRET": "OAuth client secret for gateway client credentials",
    "ZEEBE_AUTHORIZATION_SERVER_URL": (
        "OAuth token endpoint for the client credentials flow"),
    "ZEEBE_TOKEN_AUDIENCE": "OAuth audience claim requested for gateway tokens",
    "ZEEBE_CONTROL_ENABLED": (
        "closed-loop control plane (docs/control.md): controllers tick off "
        "the broker pump and drive the knob surface from the time-series "
        "store through bounded, audited actuators. 0 = the plane is not "
        "constructed (one is-None check per control pump); default on, "
        "inert without the metrics plane"),
    "ZEEBE_CONTROL_INTERVALMS": (
        "control plane: controller tick cadence (default 500ms; each tick "
        "moves each knob at most one bounded step)"),
    "ZEEBE_CONTROL_ACKP99TARGETMS": (
        "control plane: the journal-flush controller's ack-latency SLO "
        "(default 250ms) — fsync pacing widens while flush pressure "
        "threatens it"),
    "ZEEBE_CONTROL_RSSTARGETBYTES": (
        "control plane: the state-tiering controller's RSS set point; 0 "
        "(default) derives 80% of the rss_watermark alert bound"),
    "ZEEBE_FLIGHT_MAXDUMPBYTES": (
        "flight recorder: per-dump serialized-size cap (default 256KiB) — "
        "oldest ring entries drop first, the dump records truncatedEntries; "
        "0 disables bounding"),
    "ZEEBE_GATEWAY_INTERCEPTORS_": (
        "prefix family: external gateway interceptor loading — "
        "`…_<ID>_CLASSNAME` / `…_<ID>_PATH` (utils/external_code.py)"),
    "ZEEBE_GATEWAY_ADMISSION_DRAINAFTERMS": (
        "admission: /ready degrades after shedding NEW WORK for this long, "
        "so an LB can drain the gateway (0 disables; default 10s)"),
    "ZEEBE_GATEWAY_ADMISSION_ENABLED": (
        "tenant-aware admission + cooperative load shedding at the gateway "
        "and worker ingress (default true)"),
    "ZEEBE_GATEWAY_ADMISSION_MAXINFLIGHT": (
        "admission: in-flight command window for the weighted-fair tenant "
        "share (default 256; workers derive theirs from the partition "
        "backpressure limits)"),
    "ZEEBE_GATEWAY_ADMISSION_SHEDP99MS": (
        "admission: shed-ladder target — the shed level rises while the "
        "observed ack p99 exceeds this (ms, default 1000; hysteresis "
        "recovers below half)"),
    "ZEEBE_GATEWAY_REQUEST_TIMEOUT_MS": (
        "multi-process gateway: per-request routing deadline (bounded "
        "resend across workers)"),
    "ZEEBE_GATEWAY_TENANT_DEFAULTBURST": (
        "admission: default per-tenant token-bucket burst (0 derives "
        "2x rate)"),
    "ZEEBE_GATEWAY_TENANT_DEFAULTRATE": (
        "admission: default per-tenant token-bucket quota (tokens/s; "
        "0 = unmetered)"),
    "ZEEBE_GATEWAY_TENANT_QUOTAS": (
        "admission: per-tenant quota overrides, "
        "`tenant=rate[:burst],...` (e.g. `t-hot=8:16,t-batch=50`)"),
    "ZEEBE_GATEWAY_TENANT_WEIGHTS": (
        "admission: per-tenant weights for the fair in-flight share, "
        "`tenant=weight,...` (default 1.0)"),
    "ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_MODE": (
        "gateway auth mode: `none` (default) or `identity` (JWT)"),
    "ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_SECRET": (
        "HMAC secret validating gateway JWTs in identity mode"),
    "ZEEBE_GATEWAY_SECURITY_AUTHENTICATION_AUDIENCE": (
        "expected audience claim for gateway JWTs in identity mode"),
    "ZEEBE_LOG_APPENDER": "log output shape: `console` or `stackdriver` (JSON)",
    "ZEEBE_LOG_LEVEL": "root log level (info default)",
    "ZEEBE_LOG_STACKDRIVER_SERVICENAME": (
        "serviceContext.service for stackdriver-shaped logs"),
    "ZEEBE_LOG_STACKDRIVER_SERVICEVERSION": (
        "serviceContext.version for stackdriver-shaped logs"),
    "ZEEBE_PROBE_CMD": (
        "test/chaos seam: replaces the killable device-probe child command "
        "(simulate a wedged tunnel from outside the process)"),
    "ZEEBE_PROBE_TIMEOUT_S": (
        "killable device probe: hard SIGKILL deadline (seconds, default "
        "90) for the default-backend query subprocess"),
    "ZEEBE_REQUEST_DEDUPE_RETENTIONPOSITIONS": (
        "replicated request-dedupe retention: entries age out once the log "
        "advances this many positions past them (default 100k). "
        "Deterministic deployment constant — it shapes replicated-state "
        "materialization identically on processing and replay"),
    "ZEEBE_SANITIZE": (
        "tier-1 runtime sanitizer (testing/sanitizer.py): 1 = wrap "
        "ZbDb/journal/flight-recorder with single-writer and reentrancy "
        "assertions, turning latent cross-thread races into deterministic "
        "test failures"),
    "ZEEBE_TPU_NO_NATIVE": (
        "1 = disable the native C codec fast paths (pure-Python parity "
        "mode)"),
    "ZEEBE_TRACING": "1/true = enable the Dapper-style tracer",
    "ZEEBE_TRACE_CAPACITY": "tracer ring capacity (spans retained)",
    "ZEEBE_TRACE_DUMP_DIR": (
        "directory the gateway writes its span dump "
        "(spans-<node>-<pid>.jsonl) into at orderly stop, for the offline "
        "critical-path assembler; unset = no gateway dump (workers always "
        "dump into their broker data dir)"),
    "ZEEBE_TRACE_SAMPLE_RATE": "trace sampling rate in [0,1]",
    "ZEEBE_TRACE_SEED": "trace sampling hash seed (deterministic sampling)",
}

# copied from the reference: Knob .. undocumented
@dataclass
class Knob:
    name: str            # full name, or prefix family ending in "_"
    is_prefix: bool
    sites: set[str] = field(default_factory=set)     # repo-relative paths
    examples: set[str] = field(default_factory=set)  # members of a family


def scan_knobs(root: Path | str) -> list[Knob]:
    """Every ZEEBE_* knob mentioned in ``zeebe_tpu_torch/``, prefix families
    folded, sorted by name."""
    root = Path(root)
    mentions: dict[str, set[str]] = {}
    for path in sorted(root.glob("zeebe_tpu_torch/**/*.py")):
        # analysis/ excluded: KNOB_NOTES itself mentions every knob name —
        # scanning it would make stale notes self-justifying forever
        if "__pycache__" in path.parts or "analysis" in path.parts:
            continue
        rel = path.relative_to(root).as_posix()
        try:
            tree = ast.parse(path.read_text(encoding="utf-8"))
        except SyntaxError as exc:  # pragma: no cover — lint catches first
            raise RuntimeError(f"knob scan cannot parse {path}") from exc
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and _KNOB_RE.match(node.value)):
                mentions.setdefault(node.value, set()).add(rel)
    prefixes = sorted((n for n in mentions if n.endswith("_")), key=len,
                      reverse=True)
    knobs: dict[str, Knob] = {
        name: Knob(name=name, is_prefix=True, sites=set(sites))
        for name, sites in mentions.items() if name.endswith("_")
    }
    for name, sites in mentions.items():
        if name.endswith("_"):
            continue
        family = next((p for p in prefixes if name.startswith(p)), None)
        if family is not None:
            knobs[family].sites |= sites
            knobs[family].examples.add(name)
        else:
            knobs[name] = Knob(name=name, is_prefix=False, sites=set(sites))
    return sorted(knobs.values(), key=lambda k: k.name)


_KNOBS_DOC_HEADER = """\
# Environment knobs

> Auto-generated by `python -m zeebe_tpu_torch.cli knobs-doc` from an AST scan of
> every `ZEEBE_*` string literal under `zeebe_tpu_torch/` (declarative binding
> tables and prefix scans included — see zeebe_tpu_torch/analysis/knobs.py).
> **Do not edit by hand** — regenerate with
> `python -m zeebe_tpu_torch.cli knobs-doc` and commit; CI fails on drift, and a
> knob without a one-liner in `analysis/knobs.py::KNOB_NOTES` fails the
> check outright (undocumented knobs do not ship).
>
> Names ending in `_<…>` are prefix families: the tree scans the
> environment for every variable under the prefix.
"""


def render_knobs_doc(knobs: list[Knob]) -> str:
    lines = [_KNOBS_DOC_HEADER]
    lines.append(f"{len(knobs)} knobs.\n")
    lines.append("| knob | read sites | description |")
    lines.append("| --- | --- | --- |")
    for knob in knobs:
        shown = f"`{knob.name}<…>`" if knob.is_prefix else f"`{knob.name}`"
        sites = "<br>".join(f"`{s}`" for s in sorted(knob.sites))
        note = KNOB_NOTES.get(knob.name, "**(undocumented)**")
        if knob.is_prefix and knob.examples:
            examples = ", ".join(f"`{e}`" for e in sorted(knob.examples))
            note = f"{note}. In-tree members: {examples}"
        lines.append(f"| {shown} | {sites} | {note} |")
    return "\n".join(lines) + "\n"


def undocumented(knobs: list[Knob]) -> list[str]:
    return [k.name for k in knobs if k.name not in KNOB_NOTES]
# end of the copy
