"""round_ms.lm (ms): ``round_ms`` in the LM cells.  Their rounds keep the
card about 99% busy and repeat within 0.13% (PERF.md), so they take a
bound of their own, tighter than the host-bound CNN cells'."""

from chipbench.metrics.round_ms import read  # noqa: F401
