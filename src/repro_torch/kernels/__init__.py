"""The port's kernels: hand-written Hopper CUDA for the mm and bmm
recurrences (``csrc/widesa_mm.cu``), for fir and conv2d
(``csrc/widesa_sp.cu``) and for the star stencils and mttkrp
(``csrc/widesa_hpc.cu``), the fft2d composition over the mm kernel,
their plain PyTorch versions (``ref.py``), the plan-driven runtime and
the planned facade."""

from .planned import (planned_bmm, planned_conv2d, planned_dense,
                      planned_fft2d, planned_fir, planned_mlp_pair,
                      planned_report, planned_report_clear)
from .runtime import execute_plan, hopper_tiles

__all__ = [
    "execute_plan", "hopper_tiles",
    "planned_bmm", "planned_conv2d", "planned_dense", "planned_fft2d",
    "planned_fir", "planned_mlp_pair", "planned_report",
    "planned_report_clear",
]
