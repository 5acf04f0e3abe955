"""Set-up: process start to the window's start (weights, the engine's
load and capture, warming the traffic's shapes, the lead-in), host
clock."""


def read(rec):
    return rec["setup_s"]
