"""Model FLOPs done in the window over the window times the card's bf16
peak: 2 x active parameters a token (3 x that for training) plus attention
over the real context lengths (``yardstick``); recomputation is not
counted."""

from yardstick import PEAK_FLOPS


def read(rec):
    if rec.get("kind") == "train":
        w0, w1 = rec["window"]
        return rec["steps"] * rec["step_flops"] / ((w1 - w0) * PEAK_FLOPS) * 100
    steps = rec.get("steps")
    if not steps:
        return None
    span = steps[-1][1] - steps[0][0]
    return sum(s[6] for s in steps) / (span * PEAK_FLOPS) * 100
