"""Record-lineage walker: the causal tree of a process instance, from the
journal alone.

Every follow-up record in the stream back-links to the command that produced
it (``source_record_position``, carried as the sequenced batch's source
position — the same backlink replay uses for its lastProcessedPosition
tracking). That makes the committed log a complete causal-lineage substrate:
no tracing needs to have been enabled, no state db needs to be open — a
journal directory is enough to answer "where did this process instance's
records come from, in what order, triggered by which gateway request?".

The walk reconstructs a *forest*: one tree per root command (a record whose
batch has no source — a client/gateway command, a scheduled command, or an
inter-partition command). A one_task instance typically yields two trees:
the CREATE command's (instance activation through job creation) and the job
COMPLETE command's (task completion through instance completion). Roots
carrying a gateway request id are annotated with it, closing the
gateway-request → command end of the chain; pass ``exported_position`` (an
exporter's acked watermark) to close the → exporter-export end.

Surfaced via ``python -m zeebe_tpu_torch.cli trace <instance key>`` (offline, over
a journal directory) and importable for tests/tools.
"""

from __future__ import annotations

from typing import Any


def collect_lineage(stream, instance_key: int,
                    exported_position: int | None = None,
                    from_position: int = 1) -> dict:
    """Reconstruct the causal forest of ``instance_key`` from ``stream``
    (a :class:`zeebe_tpu_torch.logstreams.LogStream`).

    A record belongs to the instance when its key IS the instance key or its
    value's ``processInstanceKey`` names it; each tree additionally keeps the
    ancestor chain up to its root command (a JOB_BATCH ACTIVATE serving many
    instances appears as a partial root with only this instance's branch).
    """
    # pass 1: flat metadata for every record, plus the child index
    info: dict[int, dict[str, Any]] = {}
    children: dict[int, list[int]] = {}
    members: list[int] = []
    for view in stream.scan(from_position):
        rec = view.record  # lineage is a debug tool: full decode is fine
        value = rec.value if isinstance(rec.value, dict) else {}
        node = {
            "position": view.position,
            "sourcePosition": view.source_position,
            "recordType": rec.record_type.name,
            "valueType": rec.value_type.name,
            "intent": rec.intent.name,
            "key": rec.key,
            "timestamp": rec.timestamp,
        }
        if rec.record_type.name == "COMMAND_REJECTION":
            node["rejectionType"] = rec.rejection_type.name
            node["rejectionReason"] = rec.rejection_reason
        if rec.request_id >= 0:
            node["gatewayRequestId"] = rec.request_id
        element_id = value.get("elementId") or value.get("bpmnProcessId")
        if element_id:
            node["elementId"] = element_id
        info[view.position] = node
        if view.source_position >= 1:
            children.setdefault(view.source_position, []).append(view.position)
        if rec.key == instance_key \
                or value.get("processInstanceKey") == instance_key:
            members.append(view.position)

    # pass 2: causal closure — members plus every ancestor up to the roots
    included: set[int] = set(members)
    roots: list[int] = []
    for position in members:
        cursor = position
        while True:
            source = info[cursor]["sourcePosition"]
            if source < 1 or source not in info:
                if cursor not in roots:
                    roots.append(cursor)
                break
            included.add(source)
            cursor = source
    roots.sort()

    def build(position: int) -> dict:
        node = dict(info[position])
        node.pop("sourcePosition", None)
        if exported_position is not None:
            node["exported"] = position <= exported_position
        kids_all = children.get(position, ())
        kids = [build(p) for p in kids_all if p in included]
        if len(kids) < len(kids_all):
            # some follow-ups of this node belong to OTHER instances (e.g. a
            # JOB_BATCH ACTIVATE serving many instances) — flag the pruning
            # so consumers know this branch was filtered, not complete
            node["pruned"] = True
        if kids:
            node["children"] = kids
        return node

    trees = []
    for root in roots:
        tree = build(root)
        tree["sourcePosition"] = info[root]["sourcePosition"]
        trees.append(tree)

    return {
        "processInstanceKey": instance_key,
        "partitionId": stream.partition_id,
        "recordsScanned": len(info),
        "recordsInLineage": len(included),
        "roots": trees,
    }


def format_lineage(lineage: dict) -> str:
    """Human-readable ASCII rendering of :func:`collect_lineage`'s forest."""
    lines = [
        f"process instance {lineage['processInstanceKey']} "
        f"(partition {lineage['partitionId']}, "
        f"{lineage['recordsInLineage']}/{lineage['recordsScanned']} records)"
    ]

    def walk(node: dict, depth: int) -> None:
        request = node.get("gatewayRequestId")
        label = (
            f"#{node['position']} {node['recordType']} "
            f"{node['valueType']}.{node['intent']}"
        )
        if node.get("elementId"):
            label += f" [{node['elementId']}]"
        if request is not None:
            label += f" (gateway request {request})"
        if node.get("pruned"):
            label += " (pruned: other instances' follow-ups omitted)"
        if "exported" in node:
            label += " exported" if node["exported"] else " NOT-exported"
        lines.append("  " * depth + ("└─ " if depth else "") + label)
        for child in node.get("children", ()):
            walk(child, depth + 1)

    for tree in lineage["roots"]:
        walk(tree, 0)
    return "\n".join(lines)
