"""The outer-link term of the hierarchical cost model (the port of
``repro.core.roofline.collective_time_s``).

Only what ``core/hierarchy.py`` prices its outer splits with is copied:
``collective_time_s`` and its default link rate.  Both are parameters of
the copied planner's cost model, kept as the reference has them so that
the two packages rank outer splits alike; they are not a rate of any
card.  The reference module's roofline analysis of compiled XLA
artifacts (``collective_bytes``, ``Roofline``, ``analyze``,
``format_table`` and their peak constants) goes with the dry run's HLO
analysis, ROADMAP A9.3.
"""

from __future__ import annotations

#: the reference's default outer-link rate, bytes a second (its
#: ``ICI_BW``): a cost-model parameter
LINK_BYTES_PER_S = 50e9


def collective_time_s(nbytes: float,
                      link_gbps: float = LINK_BYTES_PER_S / 1e9) -> float:
    """Wire time for ``nbytes`` over a ``link_gbps`` GB/s interconnect:
    the outer-level term of the hierarchical combined cost model."""
    if nbytes <= 0:
        return 0.0
    return float(nbytes) / (link_gbps * 1e9)
