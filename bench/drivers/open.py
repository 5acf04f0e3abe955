"""Open-loop serving: requests arrive on the traffic's schedule whether or
not earlier ones have finished (``serving.run``)."""

import serving


def run(ctx) -> dict:
    return serving.run(ctx, "open")
