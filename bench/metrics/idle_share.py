"""Share of the traced sub-window in which nothing ran on the device."""


def read(rec):
    t = rec.get("trace")
    if not t or not t.get("window_s"):
        return None
    return (1 - t["busy_s"] / t["window_s"]) * 100
