"""Offline batch serving: a backlog that never drains in the window
(``serving.run``)."""

import serving


def run(ctx) -> dict:
    return serving.run(ctx, "batch")
