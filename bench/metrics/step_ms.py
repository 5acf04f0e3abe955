"""The window from the start of its first whole training step to the end
of its last, over the steps in it."""


def read(rec):
    if rec.get("kind") != "train":
        return None
    w0, w1 = rec["window"]
    return (w1 - w0) / rec["steps"] * 1e3
