"""local_sgd_roofline_pct (%): the least time the chip could take for a
round's frozen training FLOPs (configs/<name>.py) at the configuration's
peak, over ``local_sgd_ms``."""

from chipbench.metrics import local_sgd_ms as _ms


def read(rec):
    ms = _ms.read(rec)
    if not ms:
        return None
    return 100.0 * rec.train_flops_per_round / rec.peak_flops * 1e3 / ms
