"""round_p95_ms (ms): the 95th percentile of every round's time in the
window (host clock, stamp to stamp; ``statistics.quantiles`` over 20
parts, inclusive)."""

import statistics


def read(rec):
    if len(rec.round_ms) < 20:
        return None
    return statistics.quantiles(rec.round_ms, n=20, method="inclusive")[18]
