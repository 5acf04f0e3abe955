"""Multi-device pieces of the port (the reference's ``repro.parallel``).

Only ``collectives``' wire-byte models are ported: the hierarchical
planner (``core/hierarchy.py``) prices its outer splits with them.
"""
