"""Replicated request dedupe: the exactly-once table for client commands.

Reference shape: the gateway's retry contract in the reference engine is
safe because the broker answers a resent request from the *log*, not from
process memory. The multi-process runtime's in-memory ingress dedupe
(``multiproc/worker.py``) dies with the worker, degrading acked-command
semantics to at-most-once across a crash. This module moves the dedupe
table into partition state, materialized from the replicated log on
processing AND replay (Raft — Ongaro & Ousterhout 2014, PAPERS.md — is what
makes the log the shared source of truth), so a follower promoted to leader
or a restarted leader inherits every request's fate:

- ``REQUEST_DEDUPE``: ``(request_stream_id, request_id)`` →
  ``{"c": command position, "f": stored reply frame}``. An entry without
  ``"f"`` is *awaiting*: the command was processed but its reply (if any)
  belongs to a later step (await-result), or it produced none.
- ``REQUEST_DEDUPE_BY_POSITION``: ``(command position, stream id, request
  id)`` → None — the aging index. Entries older than
  ``RETENTION_POSITIONS`` log positions are deleted as new entries land,
  on live processing and replay alike, so the table stays bounded AND
  replay-parity holds (aging is a pure function of the log).

Materialization rule (identical on the live and replay paths — the parity
oracle ``testing.chaos.engine_state_equals`` compares this family too):

1. When a command carrying a request id is processed, write an awaiting
   entry at its position.
2. Every logged EVENT/COMMAND_REJECTION whose frame carries a request id
   (``engine/writers.py`` stamps responses) overwrites the entry with the
   reply: command position + the reply frame re-encoded with timestamp 0
   (frames are position-independent, so live and replayed bytes agree).
3. After noting, age out entries older than the retention window.

Reads from ingress use the committed-read discipline the other state
facades use (``ZbDb.committed_get``; the worker ingress handler runs on the
pump thread between transactions).
"""

from __future__ import annotations

import os

from zeebe_tpu_torch.state.db import ColumnFamilyCode, decode_key


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


#: entries whose command position is more than this many log positions
#: behind the newest note are aged out. Read once at import so every
#: processor in a process (live AND the replay oracle) agrees.
RETENTION_POSITIONS = max(
    _env_int("ZEEBE_REQUEST_DEDUPE_RETENTIONPOSITIONS", 100_000), 1)

#: replies larger than this store only the command position (the gateway
#: resend then waits for the deadline instead of a replayed reply); bounded
#: so one huge variables payload cannot bloat the dedupe table
MAX_REPLY_FRAME_BYTES = 64 * 1024


class RequestDedupeState:
    """Facade over the two dedupe column families. All writes must run
    inside the owning processor's transaction; ``lookup_committed`` is the
    cross-step committed read for ingress."""

    def __init__(self, db) -> None:
        self.db = db
        self._table = db.column_family(ColumnFamilyCode.REQUEST_DEDUPE)
        self._by_position = db.column_family(
            ColumnFamilyCode.REQUEST_DEDUPE_BY_POSITION)

    # -- writes (processing + replay, inside the step transaction) -------------

    def note_awaiting(self, position: int, stream_id: int,
                      request_id: int) -> None:
        """The command at ``position`` carrying ``(stream_id, request_id)``
        was processed; no reply recorded yet (overwritten by ``note_reply``
        when one lands in the same or a later step)."""
        self._put(stream_id, request_id, {"c": position})

    def note_reply(self, command_position: int, record) -> None:
        """``record`` (an EVENT or COMMAND_REJECTION whose frame carries the
        request identity) answers ``(record.request_stream_id,
        record.request_id)``; store the reply for resend replay. Frames are
        encoded with timestamp 0 — position and batch timestamp live outside
        the frame, so live and replayed bytes are identical."""
        frame = record.encode(timestamp=0)[0]
        entry = {"c": command_position}
        if len(frame) <= MAX_REPLY_FRAME_BYTES:
            entry["f"] = frame
        else:
            entry["big"] = True
        self._put(record.request_stream_id, record.request_id, entry)

    def _put(self, stream_id: int, request_id: int, entry: dict) -> None:
        key = (stream_id, request_id)
        prev = self._table.get(key)
        self._table.put(key, entry)
        if prev is not None and prev["c"] != entry["c"]:
            # a duplicate command slipped in below the ingress check (e.g. a
            # pre-dedupe log): the newest position owns the index entry
            self._by_position.delete((prev["c"], stream_id, request_id))
        if prev is None or prev["c"] != entry["c"]:
            self._by_position.put((entry["c"], stream_id, request_id), None)

    def age_out(self, position: int) -> None:
        """Delete entries older than the retention window below
        ``position``. O(expired) via the position index; deterministic from
        the log, so replayed state ages identically."""
        horizon = position - RETENTION_POSITIONS
        if horizon <= 0:
            return
        expired = [enc for enc, _ in self._by_position.items_below((horizon,))]
        for enc in expired:
            _cf, (old_position, stream_id, request_id) = decode_key(enc)
            self._by_position.delete((old_position, stream_id, request_id))
            self._table.delete((stream_id, request_id))

    # -- reads (ingress, committed-read discipline) ----------------------------

    @staticmethod
    def lookup_committed(db, stream_id: int, request_id: int) -> dict | None:
        """The committed dedupe entry for a request identity, or None. Safe
        from the pump thread between transactions (same discipline as the
        query facades)."""
        if request_id < 0:
            return None
        return db.committed_get(ColumnFamilyCode.REQUEST_DEDUPE,
                                (stream_id, request_id))
