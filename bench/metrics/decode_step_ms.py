"""Host time of the window's ``step()`` calls that admitted nothing and
decoded, over their count (``step()`` reads its tokens back, so each
call ends with the device's work)."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    t = [s[1] - s[0] for s in rec["steps"] if s[5] and s[2] == 0]
    return sum(t) / len(t) * 1e3 if t else None
