"""The port's kernels: hand-written Hopper CUDA for the mm and bmm
recurrences (``csrc/widesa_mm.cu``), their plain PyTorch versions
(``ref.py``), the plan-driven runtime and the planned facade."""

from .planned import (planned_bmm, planned_dense, planned_report,
                      planned_report_clear)
from .runtime import execute_plan, hopper_tiles

__all__ = [
    "execute_plan", "hopper_tiles",
    "planned_bmm", "planned_dense", "planned_report",
    "planned_report_clear",
]
