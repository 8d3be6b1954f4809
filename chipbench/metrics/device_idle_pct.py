"""device_idle_pct (%): 1 - (the union of the device events' intervals)
/ (the traced stretch), from the profiler's trace."""


def read(rec):
    if rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
