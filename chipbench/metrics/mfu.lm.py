"""mfu.lm: ``mfu`` read in the LM cells, where it moves
``round_ms.lm`` (the LM cells' round time, with a bound of its own)."""

from chipbench.metrics.mfu import read  # noqa: F401
