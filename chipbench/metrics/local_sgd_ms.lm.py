"""local_sgd_ms.lm: ``local_sgd_ms`` read in the LM cells, where it moves
``round_ms.lm`` (the LM cells' round time, with a bound of its own)."""

from chipbench.metrics.local_sgd_ms import read  # noqa: F401
