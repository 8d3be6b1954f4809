"""mix_update_roofline_pct (%): the layer's frozen ideal bytes a round
(configs/<name>.py: deltas read once, global params read and written
once) at the HBM's 3.35 TB/s, over ``mix_update_ms``."""

from chipbench import peaks
from chipbench.metrics import mix_update_ms as _ms


def read(rec):
    ms = _ms.read(rec)
    if not ms:
        return None
    return 100.0 * rec.mix_bytes_per_round / peaks.HBM_BYTES_PER_S * 1e3 / ms
