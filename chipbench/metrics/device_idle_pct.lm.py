"""device_idle_pct.lm: ``device_idle_pct`` read in the LM cells, where it moves
``round_ms.lm`` (the LM cells' round time, with a bound of its own)."""

from chipbench.metrics.device_idle_pct import read  # noqa: F401
