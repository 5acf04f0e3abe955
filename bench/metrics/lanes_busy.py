"""Mean lanes that decoded a token per decode step in the window (the
engine's lanes holding a request)."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    dec = [s[4] for s in rec["steps"] if s[5]]
    return sum(dec) / len(dec) if dec else None
