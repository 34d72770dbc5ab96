"""Mean milliseconds per journal flush in the window, from the journal's
flush histogram (every replica's journals)."""


def read(w):
    count, total = w.histogram("zeebe_journal_flush_duration_seconds")
    return 1e3 * total / count if count else None
