"""95th percentile of time to first token over every request due in an
open loop's window, from when it was due to the ``step()`` return that
handed back its first token; one still without a token at the window's
end counts the time it waited (``serving.ttft_waits``)."""

from stats import percentile


def read(rec):
    if rec.get("kind") != "serve" or rec.get("mode") != "open":
        return None
    from serving import ttft_waits

    p = percentile(ttft_waits(rec["requests"], rec["window"]), 95)
    return None if p is None else p * 1e3
