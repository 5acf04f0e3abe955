"""Kernel launches the host issued in one traced training step (the
trace's launch calls)."""


def read(rec):
    t = rec.get("trace")
    if rec.get("kind") != "train" or not t:
        return None
    return t["launch_calls"] / t["steps"]
