"""Prompt tokens prefilled plus tokens generated in the window's steps,
over the window (from its first step's start to its last step's end)."""


def read(rec):
    if rec.get("mode") != "batch" or not rec["steps"]:
        return None
    steps = rec["steps"]
    span = steps[-1][1] - steps[0][0]
    return sum(s[3] + s[2] + s[4] for s in steps) / span
