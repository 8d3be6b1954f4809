"""mix_update_ms.lm: ``mix_update_ms`` read in the LM cells, where it moves
``round_ms.lm`` (the LM cells' round time, with a bound of its own)."""

from chipbench.metrics.mix_update_ms import read  # noqa: F401
