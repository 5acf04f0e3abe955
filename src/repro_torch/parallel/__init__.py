"""Multi-device pieces of the port (the reference's ``repro.parallel``).

``mesh``, the single-controller mesh every mesh program runs on, with
its collectives; ``sharding``, the logical-axis rules and the mesh
context; ``collectives``, the wire-byte models the hierarchical planner
prices its outer splits with (``core/hierarchy.py``), the quantized
all-reduce, the ring reduce-scatter matmul and the expert-parallel MoE
dispatch; ``pipeline``, GPipe over a ``pipe`` axis.
"""

from .sharding import (
    MeshCtx,
    constrain,
    current_mesh,
    logical_to_sharding,
    use_mesh_ctx,
)

__all__ = [
    "MeshCtx",
    "constrain",
    "current_mesh",
    "logical_to_sharding",
    "use_mesh_ctx",
]
