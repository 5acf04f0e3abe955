"""Host time of the window's steps that admitted, less their count times
the decode-only step's, per 1000 prompt tokens admitted."""


def read(rec):
    if rec.get("kind") != "serve":
        return None
    dec = [s[1] - s[0] for s in rec["steps"] if s[5] and s[2] == 0]
    adm = [s for s in rec["steps"] if s[2] > 0]
    tokens = sum(s[3] for s in adm)
    if not dec or not tokens:
        return None
    per_decode = sum(dec) / len(dec)
    spent = sum(s[1] - s[0] - (per_decode if s[5] else 0.0) for s in adm)
    return spent / (tokens / 1000) * 1e3
