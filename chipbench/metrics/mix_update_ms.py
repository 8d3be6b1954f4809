"""mix_update_ms (ms a round): device time of the events launched under
the ``chipbench.mix_update`` span (``repro_torch.core.rounds._mix_and_update``
and ``_mix_and_update_quant``: packing, the mixing / aggregation kernels,
the update) in the traced blocks, over the traced rounds."""


def read(rec):
    if rec.trace is None or not rec.trace["span_count"].get(
            "chipbench.mix_update"):
        return None
    return rec.trace["span_device_s"]["chipbench.mix_update"] * 1e3 / \
        rec.traced_rounds
