"""Durable segmented journal (SURVEY.md §2.3)."""

from zeebe_tpu_torch.journal.journal import (
    ASQN_IGNORE,
    CorruptedJournalError,
    InvalidAsqnError,
    JournalRecord,
    SegmentedJournal,
    read_only_records,
)

__all__ = [
    "ASQN_IGNORE",
    "CorruptedJournalError",
    "InvalidAsqnError",
    "JournalRecord",
    "SegmentedJournal",
    "read_only_records",
]
