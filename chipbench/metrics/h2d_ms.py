"""h2d_ms (ms a round): device time of the traced blocks' ``Memcpy HtoD``
events (a block's batches and plan columns staged by the engine), over
the traced rounds."""


def read(rec):
    if rec.trace is None or rec.traced_rounds <= 0:
        return None
    return rec.trace["h2d_s"] * 1e3 / rec.traced_rounds
