"""Host ms of one page-in: the pool's ``acquire`` of a user not resident,
synchronized before and after, mean over the window's misses."""


def read(run):
    ms = run.series.get("page_in_ms") or []
    return sum(ms) / len(ms) if ms else None
