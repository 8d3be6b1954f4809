"""local_sgd_roofline_pct.lm: ``local_sgd_roofline_pct`` read in the LM cells,
where it moves ``round_ms.lm`` (the LM cells' round time, with a bound
of its own)."""

from chipbench.metrics.local_sgd_roofline_pct import read  # noqa: F401
