"""Multi-device pieces of the port (the reference's ``repro.parallel``).

``collectives``' wire-byte models (the hierarchical planner,
``core/hierarchy.py``, prices its outer splits with them) and ``mesh``,
the single-controller mesh the chip-level schedules of
``kernels/systolic.py`` run on.
"""
