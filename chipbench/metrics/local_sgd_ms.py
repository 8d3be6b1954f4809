"""local_sgd_ms (ms a round): device time of the events launched under
the ``chipbench.local_sgd`` span (``repro_torch.core.rounds.client_deltas``)
in the traced blocks, over the traced rounds."""


def read(rec):
    if rec.trace is None or not rec.trace["span_count"].get(
            "chipbench.local_sgd"):
        return None
    return rec.trace["span_device_s"]["chipbench.local_sgd"] * 1e3 / \
        rec.traced_rounds
