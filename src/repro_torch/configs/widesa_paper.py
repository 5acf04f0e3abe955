"""The paper's own benchmark suite (Table II) as a pseudo-config.

Not an LM: ``launch/recurrences.py`` drives the planner over the paper's
problem sizes and dtypes from the same table.
"""

from repro_torch.core.recurrence import PAPER_BENCHMARKS

CONFIG = PAPER_BENCHMARKS
SMOKE = PAPER_BENCHMARKS
