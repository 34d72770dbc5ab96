"""zbctl-parity CLI of the port.

Reference: clients/go/cmd/zbctl/internal/commands/*.go — status, deploy,
create instance/worker, activate jobs, complete/fail job, publish message,
broadcast signal, resolve incident, set variables. JSON in, JSON out.

Beyond zbctl parity:
  trace        — offline causal-tree reconstruction from a journal
  top          — htop-style live cluster view over GET /cluster/status
                 (``--once`` prints a single frame for scripting)
  profile      — sample a live node's threads via the management server
                 (``--folded -o out.txt`` writes flamegraph.pl/speedscope
                 collapsed stacks; ``--continuous`` reads the always-on
                 profiler's retained windows instead of blocking)
  metrics-doc  — generate zeebe_tpu_torch/docs/metrics.md from the live
                 metric registry after a one-broker scenario whose kernel
                 backend runs on the card, or on ``--device`` (the
                 committed doc: ``--device cpu``); ``--check`` fails on drift
  lint         — zlint, the AST invariant linter, over the port's tree
                 (``zeebe_tpu_torch/`` and ``chip_smoke.py``) against
                 ``zeebe_tpu_torch/.zlint-baseline``; ``--check`` is the gate
  knobs-doc    — generate zeebe_tpu_torch/docs/knobs.md from every
                 ``ZEEBE_*`` env knob the AST scanner finds (``--check``
                 fails on drift or on an undocumented knob)
  eligibility  — static kernel-eligibility report: which elements of a
                 definition ride the device kernel vs the host path, with
                 a typed catalog reason per host-forced element (offline;
                 a .bpmn file or ``--deployed --data-dir``)
  eligibility-doc — generate zeebe_tpu_torch/docs/eligibility.md from the
                 reason catalog + curated notes (``--check`` fails on drift
                 or an unexplained reason)

Every command imports what it needs when it runs: only ``metrics-doc``
(its broker's kernel backend) and ``eligibility --deployed`` (the kernel
registry's module) load torch; the gateway commands, ``lint``, the doc
gates and the offline readers load none.

Usage: python -m zeebe_tpu_torch.cli --address host:port <command> …
"""

from __future__ import annotations

import argparse
import json
import sys
import time


# copied from the reference: _out .. _out
def _out(obj) -> None:
    print(json.dumps(obj, indent=2, default=str))
# end of the copy


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="zbctl",
                                     description="tpu-zeebe cluster CLI")
    parser.add_argument("--address", default="127.0.0.1:26500",
                        help="gateway address (host:port)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("status", help="cluster topology")

    p = sub.add_parser("deploy", help="deploy BPMN resources")
    p.add_argument("files", nargs="+")

    p = sub.add_parser("create", help="create resources")
    create_sub = p.add_subparsers(dest="what", required=True)
    ci = create_sub.add_parser("instance")
    ci.add_argument("process_id")
    ci.add_argument("--variables", default="{}")
    ci.add_argument("--version", type=int, default=0)
    ci.add_argument("--with-result", action="store_true")
    cw = create_sub.add_parser("worker")
    cw.add_argument("job_type")
    cw.add_argument("--handler", default="",
                    help="python expression over `job` returning variables dict")
    cw.add_argument("--max-jobs", type=int, default=32)

    p = sub.add_parser("cancel", help="cancel instance")
    p.add_argument("what", choices=["instance"])
    p.add_argument("key", type=int)

    p = sub.add_parser("activate", help="activate jobs")
    p.add_argument("what", choices=["jobs"])
    p.add_argument("job_type")
    p.add_argument("--max-jobs", type=int, default=32)
    p.add_argument("--worker", default="zbctl")

    p = sub.add_parser("complete", help="complete job")
    p.add_argument("what", choices=["job"])
    p.add_argument("key", type=int)
    p.add_argument("--variables", default="{}")

    p = sub.add_parser("fail", help="fail job")
    p.add_argument("what", choices=["job"])
    p.add_argument("key", type=int)
    p.add_argument("--retries", type=int, required=True)
    p.add_argument("--message", default="")

    p = sub.add_parser("publish", help="publish message")
    p.add_argument("what", choices=["message"])
    p.add_argument("name")
    p.add_argument("--correlation-key", required=True)
    p.add_argument("--variables", default="{}")
    p.add_argument("--ttl", type=int, default=3_600_000)
    p.add_argument("--message-id", default="")

    p = sub.add_parser("broadcast", help="broadcast signal")
    p.add_argument("what", choices=["signal"])
    p.add_argument("name")
    p.add_argument("--variables", default="{}")

    p = sub.add_parser("resolve", help="resolve incident")
    p.add_argument("what", choices=["incident"])
    p.add_argument("key", type=int)

    p = sub.add_parser("set", help="set variables")
    p.add_argument("what", choices=["variables"])
    p.add_argument("key", type=int)
    p.add_argument("--variables", required=True)
    p.add_argument("--local", action="store_true")

    p = sub.add_parser(
        "trace",
        help="reconstruct a process instance's causal record tree from a "
             "journal (offline; no gateway needed)")
    p.add_argument("key", type=int, help="process instance key")
    p.add_argument("--journal-dir", default=None,
                   help="path to a partition's stream journal directory "
                        "(e.g. <data>/partition-1/stream, or a harness's "
                        "<dir>/log)")
    p.add_argument("--data-dir", default=None,
                   help="broker data directory; the partition is derived "
                        "from the key unless --partition is given")
    p.add_argument("--partition", type=int, default=0,
                   help="partition id override (default: decoded from key)")
    p.add_argument("--exported-position", type=int, default=None,
                   help="an exporter's acked position; annotates each node "
                        "with whether it was exported")
    p.add_argument("--pretty", action="store_true",
                   help="ASCII tree instead of JSON")

    p = sub.add_parser(
        "top",
        help="live cluster view (health, roles, rates, alerts) over the "
             "management server's /cluster/status")
    p.add_argument("--management", default="http://127.0.0.1:9600",
                   help="management server base URL")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh period, seconds")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit (scripting)")

    p = sub.add_parser(
        "profile",
        help="profile a live node over the management server's /profile "
             "endpoints (one-shot by default; --continuous reads the "
             "always-on profiler without blocking)")
    p.add_argument("--management", default="http://127.0.0.1:9600",
                   help="management server base URL")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="one-shot sampling window (server-capped at 30)")
    p.add_argument("--folded", action="store_true",
                   help="collapsed-stack output (flamegraph.pl/speedscope) "
                        "instead of JSON")
    p.add_argument("-o", "--output", default=None,
                   help="write the profile to a file instead of stdout")
    p.add_argument("--continuous", action="store_true",
                   help="read the continuous profiler's retained windows "
                        "(GET /profile/continuous) instead of taking a "
                        "blocking one-shot sample")
    p.add_argument("--since", type=int, default=0,
                   help="with --continuous: only windows ending after this "
                        "unix-ms timestamp")

    p = sub.add_parser(
        "lint",
        help="run zlint, the repo's AST-based invariant linter "
             "(offline; no gateway, no torch)")
    p.add_argument("--root", default=None,
                   help="repo root to lint (default: the tree this package "
                        "was imported from)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 on findings not covered by the committed "
                        "baseline (CI gate)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to cover current findings, "
                        "preserving existing justifications")

    p = sub.add_parser(
        "knobs-doc",
        help="generate the env-knob reference (zeebe_tpu_torch/docs/knobs.md) "
             "from the AST scanner's ZEEBE_* inventory")
    p.add_argument("--root", default=None,
                   help="repo root to scan (default: the tree this package "
                        "was imported from)")
    p.add_argument("--output", default="zeebe_tpu_torch/docs/knobs.md")
    p.add_argument("--check", action="store_true",
                   help="exit 1 if the committed file drifted or any knob "
                        "lacks a KNOB_NOTES one-liner (CI gate)")

    p = sub.add_parser(
        "eligibility",
        help="static kernel-eligibility report for process definitions: "
             "which elements ride the device kernel vs the host path, with "
             "a typed reason per host-forced element (offline; classifies "
             "a .bpmn file or everything deployed in a data dir)")
    p.add_argument("definition", nargs="?",
                   help="a .bpmn file to classify (omit with --deployed)")
    p.add_argument("--deployed", action="store_true",
                   help="classify every definition deployed in --data-dir "
                        "(read from the stream journals' PROCESS CREATED "
                        "records; call activities resolve against what is "
                        "actually deployed)")
    p.add_argument("--data-dir", default=None,
                   help="broker data dir (partition-*/ children) or one "
                        "partition's dir, for --deployed")
    p.add_argument("--pretty", action="store_true",
                   help="human-readable table instead of JSON")
    p.add_argument("-o", "--output", default=None,
                   help="write the JSON report to a file")

    p = sub.add_parser(
        "eligibility-doc",
        help="generate the eligibility reason-catalog reference "
             "(zeebe_tpu_torch/docs/eligibility.md) from the catalog + "
             "curated notes")
    p.add_argument("--root", default=None,
                   help="repo root (default: the tree this package was "
                        "imported from)")
    p.add_argument("--output", default="zeebe_tpu_torch/docs/eligibility.md")
    p.add_argument("--check", action="store_true",
                   help="exit 1 if the committed file drifted or any "
                        "catalog reason lacks a REASON_NOTES one-liner "
                        "(CI gate)")

    p = sub.add_parser(
        "snapshots",
        help="list snapshot chains (positions, sizes, validity, projected "
             "replay debt) from a data directory — offline, read-only, safe "
             "on a live or postmortem broker dir")
    p.add_argument("data_dir",
                   help="a broker data dir (partition-*/ children), one "
                        "partition's dir, or a snapshot store root")
    p.add_argument("--pretty", action="store_true",
                   help="human-readable table instead of JSON")

    p = sub.add_parser(
        "metrics-doc",
        help="generate the metrics reference (zeebe_tpu_torch/docs/metrics.md) "
             "from a representative broker scenario's live registry")
    p.add_argument("--output", default="zeebe_tpu_torch/docs/metrics.md")
    p.add_argument("--check", action="store_true",
                   help="exit 1 if the committed file drifted from the "
                        "generated content (CI gate)")
    p.add_argument("--device", default=None,
                   help="the scenario's kernel backend device (default: the "
                        "CUDA card; the committed doc is generated with "
                        "--device cpu)")

    args = parser.parse_args(argv)

    if args.cmd == "trace":
        # offline journal walk — no gateway connection
        return _trace(args)
    if args.cmd == "top":
        return _top(args)
    if args.cmd == "profile":
        return _profile(args)
    if args.cmd == "metrics-doc":
        return _metrics_doc(args)
    if args.cmd == "lint":
        # offline AST walk — stdlib only, never imports torch
        return _lint(args)
    if args.cmd == "knobs-doc":
        return _knobs_doc(args)
    if args.cmd == "eligibility":
        # offline classification — no gateway connection, no device init
        return _eligibility(args)
    if args.cmd == "eligibility-doc":
        return _eligibility_doc(args)
    if args.cmd == "snapshots":
        # offline store walk — no gateway connection
        return _snapshots(args)

    from zeebe_tpu_torch.client import JobWorker, ZeebeTpuClient

    client = ZeebeTpuClient(args.address)
    try:
        return _dispatch(client, args)
    finally:
        client.close()


# copied from the reference: _trace .. _profile
def _trace(args) -> int:
    from pathlib import Path

    from zeebe_tpu_torch.journal import SegmentedJournal
    from zeebe_tpu_torch.logstreams import LogStream
    from zeebe_tpu_torch.observability import collect_lineage, format_lineage
    from zeebe_tpu_torch.protocol.keys import decode_partition_id

    partition_id = args.partition or decode_partition_id(args.key) or 1
    if args.journal_dir:
        journal_dir = Path(args.journal_dir)
    elif args.data_dir:
        journal_dir = (Path(args.data_dir)
                       / f"partition-{partition_id}" / "stream")
        if not journal_dir.exists():
            # EngineHarness/bench layout: one partition, journal at <dir>/log
            fallback = Path(args.data_dir) / "log"
            if fallback.exists():
                journal_dir = fallback
    else:
        print("trace requires --journal-dir or --data-dir", file=sys.stderr)
        return 2
    if not journal_dir.exists():
        print(f"no journal at {journal_dir}", file=sys.stderr)
        return 2
    journal = SegmentedJournal(journal_dir)
    try:
        stream = LogStream(journal, partition_id)
        lineage = collect_lineage(stream, args.key,
                                  exported_position=args.exported_position)
        if not lineage["roots"]:
            print(f"no records for instance {args.key} in {journal_dir}",
                  file=sys.stderr)
            return 1
        if args.pretty:
            print(format_lineage(lineage))
        else:
            _out(lineage)
    finally:
        journal.close()
    return 0


# -- top: live cluster view ----------------------------------------------------


def _render_top(status: dict) -> str:
    """One frame of the `top` view from a /cluster/status payload. Pure
    (testable): no terminal control, no I/O."""
    lines = []
    topo = status.get("topology", {})
    lines.append(
        f"zeebe-tpu cluster · {status.get('clusterSize', 0)} broker(s) · "
        f"{status.get('partitionsCount', '?')} partition(s) · "
        f"health {status.get('health', '?')} · "
        f"{status.get('alertsFiring', 0)} alert(s) firing")
    lines.append(
        f"append {status.get('appendPerSec', 0.0)}/s · "
        f"processed {status.get('processedPerSec', 0.0)}/s · "
        f"topology v{topo.get('version', '?')}"
        + (" · change in progress" if topo.get("changeInProgress") else ""))
    lines.append("")
    header = (f"{'NODE':<14} {'HEALTH':<10} {'ROLES':<22} "
              f"{'APPEND/S':>9} {'PROC/S':>9} {'EXPLAG':>7} "
              f"{'PARKED':>8} {'ALERTS':>6}")
    lines.append(header)
    for row in status.get("brokers", []):
        parts = row.get("partitions", {})
        roles = " ".join(
            f"{pid}:{info['role'][:1].upper()}"
            for pid, info in sorted(parts.items(), key=lambda kv: int(kv[0]))
        ) or "-"
        rates = row.get("rates", {})
        # parked instances spilled to the cold tier (state tiering,
        parked = sum(info.get("parkedCold", 0) for info in parts.values())
        lines.append(
            f"{row.get('nodeId', '?'):<14} {row.get('health', '?'):<10} "
            f"{roles:<22} "
            f"{rates.get('appendPerSec', 0.0):>9} "
            f"{rates.get('processedPerSec', 0.0):>9} "
            f"{int(rates.get('exportLagRecords', 0)):>7} "
            f"{parked:>8} "
            f"{row.get('alertsFiring', 0):>6}")
    coverage_rows = [
        (row.get("nodeId", "?"), pid, info["kernelCoverage"])
        for row in status.get("brokers", [])
        for pid, info in sorted(row.get("partitions", {}).items(),
                                key=lambda kv: int(kv[0]))
        if info.get("kernelCoverage")
    ]
    if coverage_rows:
        # kernel-path coverage: which records rode the device
        # plane vs host per partition — the first place to look when the
        # ROADMAP item 3 coverage metric moves
        lines.append("")
        lines.append(f"{'KERNEL':<14} {'PART':>4} {'COV%':>6} "
                     f"{'KERNEL':>9} {'HOST':>9} {'DEVICE':<12} "
                     f"{'SHADOW':>7} {'MISM':>5} DOMINANT HOST REASON")
        for node, pid, cov in coverage_rows:
            # device health ladder: a QUARANTINED device is the
            # first thing to look at when a partition's COV% drops
            dev = cov.get("device", {})
            lines.append(
                f"{node:<14} {pid:>4} "
                f"{cov.get('coverageRatio', 0.0) * 100:>5.1f}% "
                f"{cov.get('kernelRecords', 0):>9} "
                f"{cov.get('hostRecords', 0):>9} "
                f"{dev.get('state', '-'):<12} "
                f"{dev.get('shadowChecks', 0):>7} "
                f"{dev.get('shadowMismatches', 0):>5} "
                f"{cov.get('dominantHostReason', '-')}")
    latency_rows = [
        (row.get("nodeId", "?"), pid, info["criticalPath"])
        for row in status.get("brokers", [])
        for pid, info in sorted(row.get("partitions", {}).items(),
                                key=lambda kv: int(kv[0]))
        if info.get("criticalPath")
    ]
    if latency_rows:
        # latency observatory: the last window's critical-path
        # verdict per partition — WHERE the worst acks spent their time,
        # not just how long they took
        lines.append("")
        lines.append(f"{'LATENCY':<14} {'PART':>4} {'ACKS':>7} "
                     f"{'WORST':>9} TOP STAGES (p99)")
        for node, pid, cp in latency_rows:
            stages = " ".join(
                f"{s.get('stage', '?')}:{s.get('p99Us', 0) / 1000.0:.2f}ms"
                for s in cp.get("topStages", [])[:3]) or "-"
            lines.append(
                f"{node:<14} {pid:>4} {cp.get('windowAcks', 0):>7} "
                f"{cp.get('worstMs', 0.0):>7.2f}ms {stages}")
    admission = status.get("admission")
    if admission and (admission.get("tenants") or admission.get("shedLevel")):
        # tenant admission: per-tenant rate/shed/queue evidence —
        # the first place to look when one tenant's p99 moves
        lines.append("")
        lines.append(
            f"ADMISSION · shed level {admission.get('shedLevel', 0)} · "
            f"p99 {admission.get('observedP99Ms', 0.0)}ms "
            f"(target {admission.get('shedP99TargetMs', '?')}ms) · "
            f"in-flight {admission.get('inflight', 0)}"
            f"/{admission.get('maxInflight', '?')}"
            + (" · DRAINING" if admission.get("draining") else ""))
        lines.append(f"{'TENANT':<18} {'ADMITTED':>9} {'SHED':>7} "
                     f"{'INFLIGHT':>8} {'QUOTA/S':>8} {'WEIGHT':>6}")
        for tenant, row in sorted(admission.get("tenants", {}).items()):
            quota = row.get("quotaRate")
            lines.append(
                f"{tenant:<18} {row.get('admitted', 0):>9} "
                f"{row.get('shed', 0):>7} {row.get('inflight', 0):>8} "
                f"{(f'{quota:g}' if quota else '-'):>8} "
                f"{row.get('weight', 1.0):>6}")
    control_rows = [(row.get("nodeId", "?"), row["control"])
                    for row in status.get("brokers", [])
                    if row.get("control")]
    if not control_rows and status.get("control"):
        control_rows = [("-", status["control"])]
    if control_rows:
        # closed-loop control plane: EVERY feedback loop — the
        # control-plane actuators plus the aggregated snapshot-scheduler /
        # admission-ladder loops — in one place, with bounds + audit counts
        lines.append("")
        lines.append(f"{'CONTROL':<14} {'LOOP':<20} {'KNOB':<26} "
                     f"{'VALUE':>9} {'BOUNDS':>15} {'ADJ':>5}")
        for node, block in control_rows:
            for name, ctl in sorted(block.get("controllers", {}).items()):
                for act in ctl.get("actuators", []):
                    bounds = f"[{act.get('min'):g},{act.get('max'):g}]"
                    lines.append(
                        f"{node:<14} {name:<20} {act.get('knob', '?'):<26} "
                        f"{act.get('value', 0):>9g} {bounds:>15} "
                        f"{act.get('adjustments', 0):>5}")
            for name, loop in sorted(block.get("loops", {}).items()):
                value = loop.get("value", loop.get("adjustments", "-"))
                lines.append(
                    f"{node:<14} {name:<20} {loop.get('knob', '?'):<26} "
                    f"{value!s:>9} {'-':>15} "
                    f"{loop.get('adjustments', 0):>5}")
    audit_rows = [(row.get("nodeId", "?"), row["audit"])
                  for row in status.get("brokers", [])
                  if row.get("audit")]
    if audit_rows:
        # fleet auditor: per-broker burn-rate state, leak
        # verdict, and latched invariant violations — the online view the
        # fleet-day gate cross-checks against the offline checker
        lines.append("")
        lines.append(f"{'AUDIT':<14} {'BURN':<8} {'FAST':>7} {'SLOW':>7} "
                     f"{'LEAK':<6} {'VIOL':>5} TRENDING RESOURCES")
        for node, audit in audit_rows:
            burn = audit.get("burn", {})
            trending = " ".join(
                f"{name}:{v.get('state', '?')}"
                for name, v in sorted(audit.get("leaks", {}).items())
                if v.get("state") not in ("quiet", "insufficient")) or "-"
            lines.append(
                f"{node:<14} {burn.get('state', '?'):<8} "
                f"{burn.get('fast', 0.0):>7.2f} "
                f"{burn.get('slow', 0.0):>7.2f} "
                f"{audit.get('leakVerdict', '?'):<6} "
                f"{audit.get('violations', 0):>5} {trending}")
    workers = status.get("workers")
    if workers:
        # multi-process deployment: the supervisor's per-worker view —
        # restart counts are the first thing to look at when routing flaps
        lines.append("")
        lines.append(f"{'WORKER':<14} {'PID':>8} {'ALIVE':<6} "
                     f"{'RESTARTS':>8}")
        for name, info in sorted(workers.items()):
            lines.append(
                f"{name:<14} {str(info.get('pid', '-')):>8} "
                f"{'yes' if info.get('alive') else 'NO':<6} "
                f"{info.get('restarts', 0):>8}")
        if "routingEpoch" in status:
            lines.append(f"routing epoch v{status['routingEpoch']}")
    firing = [a for row in status.get("brokers", [])
              for a in row.get("alerts", [])]
    if firing:
        lines.append("")
        lines.append("firing alerts:")
        for alert in firing:
            lines.append(
                f"  [{alert.get('severity', '?')}] {alert.get('rule', '?')} "
                f"{alert.get('labels', '')} value={alert.get('value', '?')} "
                f"({alert.get('expr', '')})")
    return "\n".join(lines)


def _fetch_cluster_status(base_url: str) -> dict:
    import urllib.request

    url = base_url.rstrip("/") + "/cluster/status"
    with urllib.request.urlopen(url, timeout=5) as resp:
        return json.loads(resp.read().decode())


def _top(args) -> int:
    # ValueError covers json.JSONDecodeError: a proxy error page or a wrong
    # port answering 200 with HTML must not become a raw traceback
    try:
        frame = _render_top(_fetch_cluster_status(args.management))
    except (OSError, ValueError) as exc:
        print(f"cannot reach {args.management}: {exc}", file=sys.stderr)
        return 2
    if args.once:
        print(frame)
        return 0
    try:
        while True:
            # \x1b[H home + \x1b[2J clear: classic full-repaint refresh; \x1b[J
            # after the frame clears any leftover tail from a taller frame
            sys.stdout.write(f"\x1b[H\x1b[2J{frame}\n\x1b[J")
            sys.stdout.flush()
            time.sleep(args.interval)
            frame = _render_top(_fetch_cluster_status(args.management))
    except KeyboardInterrupt:
        return 0
    except (OSError, ValueError) as exc:
        print(f"\nlost {args.management}: {exc}", file=sys.stderr)
        return 2


# -- profile: live-node profiling over the management server -------------------


def _profile(args) -> int:
    import urllib.error
    import urllib.request

    base = args.management.rstrip("/")
    if args.continuous:
        url = f"{base}/profile/continuous?since={args.since}"
    else:
        url = f"{base}/profile?seconds={args.seconds}"
    if args.folded:
        url += "&format=folded"
    # one-shot blocks server-side for the whole window: time the client
    # timeout off the requested seconds, not a constant
    timeout = 10.0 + (0 if args.continuous else args.seconds)
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            body = resp.read().decode()
    except urllib.error.HTTPError as exc:
        # the server WAS reached and its JSON body says what went wrong
        # (e.g. 404 "continuous profiler disabled (profiling_hz=0)") —
        # surface that, not a generic unreachable message
        detail = exc.read().decode(errors="replace").strip() or exc.reason
        print(f"{args.management} answered {exc.code}: {detail}",
              file=sys.stderr)
        return 2
    except (OSError, ValueError) as exc:
        print(f"cannot reach {args.management}: {exc}", file=sys.stderr)
        return 2
    if args.output:
        from pathlib import Path

        out_path = Path(args.output)
        out_path.write_text(body if body.endswith("\n") else body + "\n")
        lines = body.count("\n") + 1
        print(f"wrote {out_path} ({lines} line(s))", file=sys.stderr)
    else:
        print(body)
    return 0
# end of the copy


# -- metrics-doc: generated metric reference -----------------------------------

_METRICS_DOC_HEADER = """\
# Metrics reference

> Auto-generated by `python -m zeebe_tpu_torch.cli metrics-doc --device cpu`
> from the live metric registry after a representative single-broker
> scenario (boot, deploy, process, snapshot, checkpoint,
> exporter/gateway/DMN component construction). **Do not edit by hand** —
> regenerate with `python -m zeebe_tpu_torch.cli metrics-doc --device cpu`
> and commit; `--check` fails on drift, on the CPU as on the card (no
> `--device`): the scenario registers the same families on both.
>
> Conventions: histograms additionally expose `_bucket`/`_sum`/`_count`
> series on `/metrics`; every series is retained as history by the
> in-memory time-series store (`GET /timeseries`, counters as rates,
> histograms as p50/p99) while the broker's sampler is enabled.
"""


def _register_metrics_scenario(device=None) -> None:
    """Run the representative scenario whose side effect is registering
    every metric family: a single-broker deterministic cluster processing a
    deployment, a snapshot, a checkpoint, plus the components that register
    at construction (ES exporter, gateway rpc wrappers, DMN counter,
    process self-metrics)."""
    import tempfile

    from zeebe_tpu_torch.backup.checkpoint import CheckpointState
    from zeebe_tpu_torch.broker.broker import InProcessCluster
    from zeebe_tpu_torch.exporters import ElasticsearchExporter
    from zeebe_tpu_torch.exporters.api import Exporter
    from zeebe_tpu_torch.models.bpmn import Bpmn, to_bpmn_xml
    from zeebe_tpu_torch.protocol import ValueType, command
    from zeebe_tpu_torch.protocol.intent import DeploymentIntent
    from zeebe_tpu_torch.utils.metrics import install_process_metrics

    class _SinkExporter(Exporter):
        def export(self, record) -> None:
            self.controller.update_last_exported_position(record.position)

    with tempfile.TemporaryDirectory() as tmp:
        cluster = InProcessCluster(
            broker_count=1, partition_count=1, replication_factor=1,
            directory=tmp, device=device,
            exporters_factory=lambda: {"recording": _SinkExporter()})
        try:
            cluster.await_leaders()
            model = (Bpmn.create_executable_process("metrics_doc")
                     .start_event("s").end_event("e").done())
            cluster.write_command(1, command(
                ValueType.DEPLOYMENT, DeploymentIntent.CREATE,
                {"resources": [{"resourceName": "m.bpmn",
                                "resource": to_bpmn_xml(model)}]}))
            cluster.run(500)
            partition = cluster.leader(1)
            partition.take_snapshot()
            with partition.db.transaction():
                CheckpointState(partition.db).put(1, 1)
        finally:
            cluster.close()
    ElasticsearchExporter(sink=lambda payload: None)
    import zeebe_tpu_torch.engine.decision  # noqa: F401 — registers the DMN counter
    # families: killable device probe + worker supervision
    from zeebe_tpu_torch.multiproc.supervisor import WorkerSupervisor
    from zeebe_tpu_torch.utils import backend_probe

    backend_probe._probe_metric()
    WorkerSupervisor([])
    # family: the gateway's bounded-resend deadline counter lives
    # at module level in the multi-process runtime
    import zeebe_tpu_torch.multiproc.runtime  # noqa: F401
    # families: the control_adjust audit vocabulary — explicit so
    # the doc stays deterministic even with ZEEBE_CONTROL_ENABLED=0
    import zeebe_tpu_torch.control.audit  # noqa: F401
    # families: tenant admission (module-level) + one controller so
    # the labeled gauges/histogram exist; messaging's zombie-client counter
    import zeebe_tpu_torch.cluster.messaging  # noqa: F401
    from zeebe_tpu_torch.gateway.admission import AdmissionCfg, AdmissionController

    AdmissionController(AdmissionCfg(), node_id="gateway")
    from zeebe_tpu_torch.gateway.gateway import _wrap

    def Topology(request, context):  # noqa: N802 — rpc-shaped name
        return None

    _wrap(Topology)
    install_process_metrics()


# copied from the reference: _render_metrics_doc .. _render_metrics_doc
def _render_metrics_doc() -> str:
    from zeebe_tpu_torch.utils.metrics import REGISTRY

    def cell(text: str) -> str:
        return text.replace("|", "\\|").replace("\n", " ")

    families = REGISTRY.describe()
    lines = [_METRICS_DOC_HEADER]
    lines.append(f"{len(families)} metric families.\n")
    lines.append("| name | type | labels | help |")
    lines.append("| --- | --- | --- | --- |")
    for fam in families:
        labels = ", ".join(f"`{n}`" for n in fam["labels"]) or "—"
        lines.append(
            f"| `{fam['name']}` | {fam['type']} | {labels} "
            f"| {cell(fam['help']) or '—'} |")
    return "\n".join(lines) + "\n"
# end of the copy


def _metrics_doc(args) -> int:
    from pathlib import Path

    # the scenario boots a broker whose kernel backend runs on the card
    # unless --device names another device
    _register_metrics_scenario(args.device)
    content = _render_metrics_doc()
    path = Path(args.output)
    if args.check:
        committed = path.read_text() if path.exists() else ""
        if committed != content:
            print(f"{path} drifted from the registry — regenerate with "
                  f"`python -m zeebe_tpu_torch.cli metrics-doc --device cpu`",
                  file=sys.stderr)
            import difflib

            diff = difflib.unified_diff(
                committed.splitlines(), content.splitlines(),
                fromfile=str(path), tofile="generated", lineterm="", n=1)
            for line in list(diff)[:40]:
                print(line, file=sys.stderr)
            return 1
        print(f"{path} is up to date ({content.count(chr(10))} lines)")
        return 0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(content)
    print(f"wrote {path}")
    return 0


# copied from the reference: _repo_root .. _dispatch
def _repo_root(arg: str | None):
    from pathlib import Path

    if arg:
        return Path(arg)
    # the tree this package was imported from: zeebe_tpu_torch/cli.py -> repo root
    return Path(__file__).resolve().parent.parent


def _lint(args) -> int:
    from zeebe_tpu_torch.analysis import (
        BASELINE_FILENAME, format_baseline, load_baseline, run_lint,
        split_findings)

    root = _repo_root(args.root)
    baseline_path = root / BASELINE_FILENAME
    findings = run_lint(root)
    baseline = load_baseline(baseline_path)
    new, stale = split_findings(findings, baseline)

    if args.update_baseline:
        baseline_path.write_text(format_baseline(findings, baseline))
        todo = sum(1 for f in findings
                   if baseline.get(f.baseline_key, "").strip()
                   in ("", "TODO: justify"))
        print(f"wrote {baseline_path} ({len({f.baseline_key for f in findings})}"
              f" entries, {todo} needing justification)")
        return 0

    for f in new:
        print(f.render())
    for key in stale:
        print(f"stale baseline entry (no longer matches anything — remove "
              f"it): {chr(9).join(key)}", file=sys.stderr)
    covered = len(findings) - len(new)
    summary = (f"zlint: {len(findings)} finding(s) — {len(new)} new, "
               f"{covered} baselined, {len(stale)} stale baseline entr(ies)")
    # stale entries fail the gate too: a fixed violation must shrink the
    # baseline in the same change, or the dedicated lint job and the tier-1
    # tree-gate test would disagree about the same tree state
    if (new or stale) and args.check:
        print(f"{summary}\nfix the findings above, suppress inline with "
              f"`# zlint: disable=<rule>` next to a justification, or "
              f"refresh {BASELINE_FILENAME} via `cli lint --update-baseline` "
              f"(new entries need a one-line justification; stale entries "
              f"are dropped)", file=sys.stderr)
        return 1
    print(summary)
    return 1 if (new or stale) else 0


def _knobs_doc(args) -> int:
    from pathlib import Path

    from zeebe_tpu_torch.analysis import render_knobs_doc, scan_knobs
    from zeebe_tpu_torch.analysis.knobs import undocumented

    root = _repo_root(args.root)
    knobs = scan_knobs(root)
    content = render_knobs_doc(knobs)
    path = Path(args.output)
    if not path.is_absolute():
        path = root / path
    if args.check:
        from zeebe_tpu_torch.analysis.knobs import KNOB_NOTES

        missing = undocumented(knobs)
        if missing:
            print(f"undocumented env knob(s): {', '.join(missing)} — add a "
                  f"one-liner to zeebe_tpu_torch/analysis/knobs.py::KNOB_NOTES and "
                  f"regenerate with `python -m zeebe_tpu_torch.cli knobs-doc`",
                  file=sys.stderr)
            return 1
        stale_notes = sorted(set(KNOB_NOTES) - {k.name for k in knobs})
        if stale_notes:
            print(f"stale KNOB_NOTES entr(ies) with no in-tree read: "
                  f"{', '.join(stale_notes)} — the knob was removed/renamed; "
                  f"drop the note and regenerate", file=sys.stderr)
            return 1
        committed = path.read_text() if path.exists() else ""
        if committed != content:
            print(f"{path} drifted from the env-knob scan — regenerate with "
                  f"`python -m zeebe_tpu_torch.cli knobs-doc`", file=sys.stderr)
            import difflib

            diff = difflib.unified_diff(
                committed.splitlines(), content.splitlines(),
                fromfile=str(path), tofile="generated", lineterm="", n=1)
            for line in list(diff)[:40]:
                print(line, file=sys.stderr)
            return 1
        print(f"{path} is up to date ({len(knobs)} knobs)")
        return 0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(content)
    print(f"wrote {path} ({len(knobs)} knobs)")
    return 0


# -- eligibility: static kernel-path classification -----------------


class _OfflineProcesses:
    """Minimal ProcessState shim over journal-harvested deployments, so the
    classifier's call-activity inlining resolves against what is actually
    deployed (the two methods _inline_call_activities consults)."""

    def __init__(self, defs: dict[str, dict]) -> None:
        # bpmnProcessId → {"meta": …, "exe": ExecutableProcess}
        self._defs = defs
        self._by_key = {d["meta"]["processDefinitionKey"]: d
                       for d in defs.values()}

    def get_latest_by_id(self, process_id: str, tenant=None):
        entry = self._defs.get(process_id)
        return entry["meta"] if entry else None

    def executable(self, key: int):
        entry = self._by_key.get(key)
        return entry["exe"] if entry else None


def _harvest_deployed(data_dir) -> dict[str, dict]:
    """Latest deployed definition per bpmnProcessId, read offline from the
    stream journals' PROCESS CREATED events (the resource XML rides the
    event — no state load, no device init, safe on a live broker dir)."""
    from zeebe_tpu_torch.journal import SegmentedJournal
    from zeebe_tpu_torch.logstreams import LogStream
    from zeebe_tpu_torch.models.bpmn import parse_bpmn_xml
    from zeebe_tpu_torch.models.bpmn.executable import transform
    from zeebe_tpu_torch.protocol import RecordType, ValueType
    from zeebe_tpu_torch.protocol.intent import ProcessIntent

    # broker layout (<dir>/partition-N/stream), standalone layout
    # (<dir>/broker-N/partition-N/stream), or one partition's dir
    journal_dirs = sorted(data_dir.glob("partition-*/stream")) or sorted(
        data_dir.glob("*/partition-*/stream"))
    if not journal_dirs:
        # EngineHarness/bench layout: one partition, journal at <dir>/log
        for candidate in (data_dir / "log", data_dir / "stream", data_dir):
            if candidate.is_dir() and any(candidate.glob("journal-*.log")):
                journal_dirs = [candidate]
                break
    defs: dict[str, dict] = {}
    for journal_dir in journal_dirs:
        journal = SegmentedJournal(journal_dir)
        try:
            stream = LogStream(journal, partition_id=1)
            for view in stream.scan_filtered(
                    1, int(RecordType.EVENT), int(ValueType.PROCESS),
                    int(ProcessIntent.CREATED)):
                value = view.value
                pid = value.get("bpmnProcessId")
                if not pid or "resource" not in value:
                    continue
                known = defs.get(pid)
                if known and known["meta"]["version"] >= value.get("version", 1):
                    continue
                model = next((m for m in parse_bpmn_xml(value["resource"])
                              if m.process_id == pid), None)
                if model is None:
                    continue
                defs[pid] = {
                    "meta": {
                        "bpmnProcessId": pid,
                        "version": value.get("version", 1),
                        "processDefinitionKey":
                            value.get("processDefinitionKey", view.key),
                    },
                    "exe": transform(model),
                }
        finally:
            journal.close()
    return defs


def _render_eligibility(reports: list[dict]) -> str:
    """Human-readable view of classification reports (``--pretty``)."""
    lines = []
    for report in reports:
        counts = report.get("counts", {})
        verdict = ("KERNEL-ELIGIBLE" if report.get("eligible")
                   else "HOST-FORCED "
                        f"({', '.join(report.get('definitionReasons', []))})")
        lines.append(f"{report.get('bpmnProcessId', '?')}: {verdict} · "
                     f"{counts.get('kernel', 0)} kernel / "
                     f"{counts.get('host', 0)} host element(s)")
        for el in report.get("elements", []):
            if el.get("path") == "host":
                lines.append(f"  host   {el.get('id', '?'):<24} "
                             f"{el.get('type', '?'):<26} "
                             f"{el.get('reason', '')}")
        lines.append("")
    lines.append("runtime-only reasons (never statically predictable): "
                 + ", ".join(reports[0].get("runtimeOnlyReasons", []))
                 if reports else "no definitions found")
    return "\n".join(lines)


def _eligibility(args) -> int:
    from pathlib import Path

    from zeebe_tpu_torch.engine.eligibility import classify_definition

    reports: list[dict] = []
    if args.deployed:
        if not args.data_dir:
            print("eligibility --deployed requires --data-dir",
                  file=sys.stderr)
            return 2
        data_dir = Path(args.data_dir)
        if not data_dir.exists():
            print(f"no data dir at {data_dir}", file=sys.stderr)
            return 2
        defs = _harvest_deployed(data_dir)
        if not defs:
            print(f"no deployed definitions found under {data_dir}",
                  file=sys.stderr)
            return 1
        from zeebe_tpu_torch.engine.kernel_backend import KernelRegistry

        processes = _OfflineProcesses(defs)
        # ONE shared registry across the whole deployment set: the report
        # must see what runtime admission will — joint SlotMap clashes and
        # registry capacity (table-set-full) are invisible to solo passes
        registry = KernelRegistry()
        for pid in sorted(defs):
            entry = defs[pid]
            reports.append(classify_definition(
                entry["exe"], processes=processes,
                definition_key=entry["meta"]["processDefinitionKey"],
                registry=registry))
    else:
        if not args.definition:
            print("eligibility requires a .bpmn file or --deployed "
                  "--data-dir", file=sys.stderr)
            return 2
        path = Path(args.definition)
        if not path.exists():
            print(f"no such file: {path}", file=sys.stderr)
            return 2
        from zeebe_tpu_torch.models.bpmn import parse_bpmn_xml
        from zeebe_tpu_torch.models.bpmn.executable import (
            ProcessValidationError,
            transform,
        )

        for model in parse_bpmn_xml(path.read_text()):
            try:
                reports.append(classify_definition(transform(model)))
            except ProcessValidationError as exc:
                print(f"{model.process_id}: not deployable ({exc})",
                      file=sys.stderr)
                return 1
        if not reports:
            print(f"no process definitions in {path}", file=sys.stderr)
            return 1
    payload = {"definitions": reports}
    if args.output:
        Path(args.output).write_text(json.dumps(payload, indent=1) + "\n")
        print(f"wrote {args.output} ({len(reports)} definition(s))",
              file=sys.stderr)
    if args.pretty:
        print(_render_eligibility(reports))
    elif not args.output:
        _out(payload)
    return 0


def _eligibility_doc(args) -> int:
    from pathlib import Path

    from zeebe_tpu_torch.analysis.eligibility_notes import (
        REASON_NOTES,
        render_eligibility_doc,
        stale_reason_notes,
        undocumented_reasons,
    )

    root = _repo_root(args.root)
    content = render_eligibility_doc()
    path = Path(args.output)
    if not path.is_absolute():
        path = root / path
    if args.check:
        missing = undocumented_reasons()
        if missing:
            print(f"unexplained eligibility reason(s): {', '.join(missing)} "
                  f"— add a one-liner to zeebe_tpu_torch/analysis/"
                  f"eligibility_notes.py::REASON_NOTES and regenerate with "
                  f"`python -m zeebe_tpu_torch.cli eligibility-doc`",
                  file=sys.stderr)
            return 1
        stale = stale_reason_notes()
        if stale:
            print(f"stale REASON_NOTES entr(ies) for retired code(s): "
                  f"{', '.join(stale)} — drop the note and regenerate",
                  file=sys.stderr)
            return 1
        committed = path.read_text() if path.exists() else ""
        if committed != content:
            print(f"{path} drifted from the reason catalog — regenerate "
                  f"with `python -m zeebe_tpu_torch.cli eligibility-doc`",
                  file=sys.stderr)
            import difflib

            diff = difflib.unified_diff(
                committed.splitlines(), content.splitlines(),
                fromfile=str(path), tofile="generated", lineterm="", n=1)
            for line in list(diff)[:40]:
                print(line, file=sys.stderr)
            return 1
        print(f"{path} is up to date ({len(REASON_NOTES)} reasons)")
        return 0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(content)
    print(f"wrote {path} ({len(REASON_NOTES)} reasons)")
    return 0


# -- snapshots: offline chain inspection ---------------------------------------


# mirror of broker/partition.py DEFAULT_REPLAY_RATE_RPS (kept local: the
# partition module pulls the engine/jax stack, which an offline inspection
# tool must never initialize)
_REPLAY_RATE_RPS = 10_000.0


def _snapshot_stores(root) -> list[tuple[str, "Path", "Path | None"]]:
    """Resolve ``(label, store_root, stream_journal_dir)`` triples from any
    of the accepted layouts: a broker data dir (``partition-*/`` children),
    one partition's dir, or a bare snapshot store root."""
    partitions = sorted(p for p in root.glob("partition-*") if p.is_dir())
    if partitions:
        return [(p.name, p / "snapshots", p / "stream") for p in partitions
                if (p / "snapshots").is_dir()]
    # a partition dir holds the store root at <dir>/snapshots (which itself
    # holds the committed snapshots at <store>/snapshots/<id>/)
    if (root / "snapshots" / "snapshots").is_dir():
        return [(root.name, root / "snapshots", root / "stream")]
    if (root / "snapshots").is_dir():
        return [(root.name, root, None)]
    return []


def _inspect_partition(label: str, store_root, stream_dir) -> dict:
    from zeebe_tpu_torch.journal import read_only_records
    from zeebe_tpu_torch.logstreams.log_stream import _py_scan_batch_headers
    from zeebe_tpu_torch.state.snapshot import inspect_store

    snapshots = inspect_store(store_root)
    # the recovery anchor is the NEWEST snapshot whose whole chain
    # validates — exactly what partition recovery would install
    anchor = next((s for s in reversed(snapshots) if s["chainValid"]), None)
    anchor_processed = anchor["processedPosition"] if anchor else -1
    journal_end = None
    debt = None
    if stream_dir is not None and stream_dir.is_dir():
        journal_end, debt = -1, 0
        for jrec in read_only_records(stream_dir):
            try:
                _, _, records = _py_scan_batch_headers(jrec.data)
            except Exception:  # noqa: BLE001 — stop at the torn tail
                break
            for rec in records:
                position = rec[1]
                journal_end = max(journal_end, position)
                if position > anchor_processed:
                    debt += 1
    out = {
        "partition": label,
        "store": str(store_root),
        "snapshots": snapshots,
        "recoveryAnchor": None if anchor is None else {
            "id": anchor["id"],
            "chainLength": anchor["chainLength"],
            "processedPosition": anchor["processedPosition"],
        },
        "journalEndPosition": journal_end,
        "replayDebtRecords": debt,
    }
    if debt is not None:
        out["projectedReplayMs"] = round(debt * 1000.0 / _REPLAY_RATE_RPS, 1)
    return out


def _render_snapshots(report: dict) -> str:
    lines = []
    for part in report["partitions"]:
        anchor = part["recoveryAnchor"]
        lines.append(f"{part['partition']} · {part['store']}")
        lines.append(
            f"  recovery anchor: "
            + (f"{anchor['id']} (chain {anchor['chainLength']})"
               if anchor else "none — full replay from log start"))
        if part["replayDebtRecords"] is not None:
            lines.append(
                f"  journal end {part['journalEndPosition']} · replay debt "
                f"{part['replayDebtRecords']} records "
                f"(~{part['projectedReplayMs']}ms at "
                f"{int(_REPLAY_RATE_RPS)} rec/s)")
        header = (f"  {'id':<24} {'kind':<14} {'processed':>9} "
                  f"{'exported':>9} {'bytes':>10} {'chain':>5} valid")
        lines.append(header)
        for s in part["snapshots"]:
            valid = ("ok" if s["chainValid"]
                     else ("torn" if not s["valid"] else "broken-chain"))
            lines.append(
                f"  {s['id']:<24} {s['kind']:<14} "
                f"{s['processedPosition']:>9} {s['exportedPosition']:>9} "
                f"{s['sizeBytes']:>10} {s['chainLength']:>5} {valid}")
        if not part["snapshots"]:
            lines.append("  (no snapshots)")
        lines.append("")
    return "\n".join(lines).rstrip()


def _snapshots(args) -> int:
    from pathlib import Path

    root = Path(args.data_dir)
    if not root.is_dir():
        print(f"no such directory: {root}", file=sys.stderr)
        return 2
    stores = _snapshot_stores(root)
    if not stores:
        print(f"no snapshot stores under {root} (expected partition-*/ "
              f"children, a partition dir, or a store root)", file=sys.stderr)
        return 2
    report = {"dataDir": str(root), "partitions": [
        _inspect_partition(label, store_root, stream_dir)
        for label, store_root, stream_dir in stores
    ]}
    if args.pretty:
        print(_render_snapshots(report))
    else:
        _out(report)
    return 0


def _dispatch(client, args) -> int:
    if args.cmd == "status":
        topo = client.topology()
        _out({"clusterSize": topo.cluster_size,
              "partitionsCount": topo.partitions_count,
              "replicationFactor": topo.replication_factor,
              "gatewayVersion": topo.gateway_version,
              "brokers": topo.brokers})
    elif args.cmd == "deploy":
        _out(client.deploy_resource(*args.files))
    elif args.cmd == "create" and args.what == "instance":
        variables = json.loads(args.variables)
        if args.with_result:
            result = client.create_instance_with_result(
                args.process_id, version=args.version, variables=variables)
            _out({"processInstanceKey": result.process_instance_key,
                  "variables": result.variables})
        else:
            instance = client.create_instance(
                args.process_id, version=args.version, variables=variables)
            _out({"processDefinitionKey": instance.process_definition_key,
                  "bpmnProcessId": instance.bpmn_process_id,
                  "version": instance.version,
                  "processInstanceKey": instance.process_instance_key})
    elif args.cmd == "create" and args.what == "worker":
        handler_expr = args.handler or "{}"

        def handler(job):
            return eval(handler_expr, {"job": job, "json": json})  # noqa: S307

        from zeebe_tpu_torch.client import JobWorker

        worker = JobWorker(client, args.job_type, handler,
                           max_jobs_active=args.max_jobs).start()
        print(f"worker on '{args.job_type}' started; ctrl-c to stop",
              file=sys.stderr)
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            worker.stop()
    elif args.cmd == "cancel":
        client.cancel_instance(args.key)
        _out({"canceled": args.key})
    elif args.cmd == "activate":
        jobs = client.activate_jobs(args.job_type, max_jobs=args.max_jobs,
                                    worker=args.worker)
        _out({"jobs": [vars(j) for j in jobs]})
    elif args.cmd == "complete":
        client.complete_job(args.key, json.loads(args.variables))
        _out({"completed": args.key})
    elif args.cmd == "fail":
        client.fail_job(args.key, args.retries, args.message)
        _out({"failed": args.key, "retries": args.retries})
    elif args.cmd == "publish":
        key = client.publish_message(args.name, args.correlation_key,
                                     json.loads(args.variables), args.ttl,
                                     args.message_id)
        _out({"messageKey": key})
    elif args.cmd == "broadcast":
        key = client.broadcast_signal(args.name, json.loads(args.variables))
        _out({"signalKey": key})
    elif args.cmd == "resolve":
        client.resolve_incident(args.key)
        _out({"resolved": args.key})
    elif args.cmd == "set":
        key = client.set_variables(args.key, json.loads(args.variables),
                                   local=args.local)
        _out({"key": key})
    return 0
# end of the copy


if __name__ == "__main__":
    sys.exit(main())
