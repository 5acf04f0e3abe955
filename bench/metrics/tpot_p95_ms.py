"""95th percentile, over the requests that finished in the window, of the
time from a request's first token to its last over its tokens less one."""

from stats import percentile


def read(rec):
    if rec.get("kind") != "serve":
        return None
    w0, w1 = rec["window"]
    per = [(r["last"] - r["first"]) / (r["n"] - 1) for r in rec["requests"]
           if r["done"] is not None and w0 <= r["done"] <= w1 and r["n"] > 1]
    p = percentile(per, 95)
    return None if p is None else p * 1e3
