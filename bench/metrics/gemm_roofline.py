"""The GEMMs' least time at the card's peaks over their kernels' device
time, in the traced sub-window, as a share.  Their work is counted from
shapes (``yardstick``: the captured decode step's from the
configuration's widths, the eager ones from the facade's shape records);
their time is the port's GEMM kernels' records in the trace.  Nothing is
read where the trace holds another number of GEMM kernel records than
the shapes call for: the profiler lost records."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("gemm_s"):
        return None
    if t["gemm_records"] != t["gemm"]["launches"]:
        return None
    return t["gemm"]["bound_s"] / t["gemm_s"] * 100
