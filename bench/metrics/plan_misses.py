"""Plan resolutions inside the window: the crossover table's misses plus
races (``core.autotune.counters()``, read before and after the window); a
shape the set-up did not warm plans here."""


def read(rec):
    return rec.get("plan_misses")
