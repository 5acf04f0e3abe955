"""Space-time transformation (paper §III-B1) — the port's copy of
``repro.core.spacetime``, kept line-for-line so plans match.

Given a uniform recurrence, enumerate legal systolic schedules:

  * candidate space loops = loops on which every dependence has
    |distance| <= 1  (paper: "dependence distances no greater than one");
  * choose 1 or 2 space loops (the AIE array / chip mesh is 2-D);
  * the remaining loops become time loops;
  * legality: there must exist a schedule (time ordering) that executes the
    source of every dependence before its sink — for uniform recurrences with
    non-negative distances and lexicographic time order this holds iff every
    dependence has a non-negative distance on some time loop, or is fully
    carried by the space loops with |d| <= 1 (neighbour communication).

The output is a set of ``SystolicSchedule`` objects ranked later by the
partition/cost model.
"""

from __future__ import annotations

import dataclasses
import itertools

from .recurrence import Dependence, UniformRecurrence


@dataclasses.dataclass(frozen=True)
class SystolicSchedule:
    """A space-time mapping of a uniform recurrence.

    ``space_loops``: loops mapped to array axes (1 or 2 of them) — these
    become mesh axes / Pallas parallel grid dims.
    ``time_loops``: remaining loops, outermost-first, executed sequentially.
    ``comm``: per-dependence communication classification under this mapping:
        'neighbour'  — non-zero constant distance on a space loop (systolic
                       ppermute / AIE DMA edge)
        'broadcast'  — read dep carried by a space loop with distance 0 on
                       all space loops (all-gather / PLIO broadcast)
        'local'      — carried entirely by time loops (stays in one PE)
        'reduce'     — output dep across a space loop (reduce-scatter edge)
    """

    recurrence_name: str
    space_loops: tuple[str, ...]
    time_loops: tuple[str, ...]
    comm: tuple[tuple[Dependence, str], ...]

    @property
    def ndim(self) -> int:
        return len(self.space_loops)

    def describe(self) -> str:
        c = ", ".join(f"{d.array}:{d.kind}->{cls}" for d, cls in self.comm)
        return (
            f"space=({','.join(self.space_loops)}) "
            f"time=({','.join(self.time_loops)}) comm=[{c}]"
        )


def candidate_space_loops(rec: UniformRecurrence) -> list[str]:
    """Loops whose dependences admit neighbour-stream lowering on a space
    axis.

    Three rules compose here:

    * **distance rule** (paper §III-B1) for *flow*/*output* dependences:
      |distance| <= 1 — partial sums and true dependences must move at
      most one hop per step.
    * **width-k refinement** for *read* dependences: a read dep of
      constant distance k > 1 (a higher-order stencil's star points, e.g.
      the radius-2 9-point star) is still space-legal — it lowers to a
      *width-k halo*: one ppermute of a k-wide edge strip, a single hop as
      long as k fits inside the adjacent shard (checked at lowering time,
      ``kernels/systolic.py``).
    * **flow rule** for time-iterated recurrences (multi-sweep
      stencils): a flow dependence along loop ``t`` carried by an array
      indexed only by the *other* loops (e.g. jacobi2d_ms's ``O[i,j]``
      across sweeps) transfers the entire intermediate plane between
      consecutive ``t`` iterations.  Mapped to a space axis that is not a
      neighbour stream — every step the full state would cross one array
      edge, which the congestion model rejects for any non-trivial extent
      — so such loops stay temporal and the dependence lowers to the halo
      exchange between sweeps instead.
    """
    deps = rec.dependences()
    out = []
    for loop in rec.loops:
        if any(abs(d.dist(loop)) > 1 for d in deps if d.kind != "read"):
            continue
        if any(d.kind == "flow" and d.dist(loop) != 0 for d in deps):
            continue
        out.append(loop)
    return out


def classify_comm(
    dep: Dependence, space: tuple[str, ...], time: tuple[str, ...]
) -> str:
    space_d = [dep.dist(l) for l in space]
    if any(d != 0 for d in space_d):
        if dep.kind == "output":
            return "reduce"
        return "neighbour"
    # distance zero on all space loops: data is either local to a PE or
    # (for read deps whose reuse direction is a space loop... handled above)
    # needed by every PE along unmapped loops -> local if carried by time.
    if dep.kind == "read":
        # read dep with zero space distance: the array is indexed by a space
        # loop (private per PE column) -> local; it still enters via the
        # array edge, which the PLIO stage accounts for.
        return "local"
    if dep.kind == "output":
        return "local"
    return "local"


def _legal(
    rec: UniformRecurrence, space: tuple[str, ...], time: tuple[str, ...]
) -> bool:
    """Schedule legality (paper: space-time transformation legality).

    With lexicographic execution of ``time`` loops, a dependence is satisfied
    iff its distance vector restricted to time loops is lexicographically
    non-negative; flow/output dependences carried purely by space loops must
    be neighbour-distance (|d| <= 1) so they lower to one-hop communication.
    Read dependences are exempt from the space-distance cap (width-k halo
    refinement — see ``candidate_space_loops``).
    """
    for dep in rec.dependences():
        tvec = [dep.dist(l) for l in time]
        svec = [dep.dist(l) for l in space]
        # lexicographic sign of the time part
        sign = 0
        for d in tvec:
            if d != 0:
                sign = 1 if d > 0 else -1
                break
        if sign < 0:
            return False  # would need to run time backwards
        if (sign == 0 and dep.kind != "read"
                and any(abs(d) > 1 for d in svec)):
            return False  # multi-hop space communication in a single step
    return True


def enumerate_schedules(
    rec: UniformRecurrence, max_space_dims: int = 2
) -> list[SystolicSchedule]:
    """Enumerate all legal 1-D/2-D systolic schedules (paper §III-B1).

    Mirrors the paper: enumerate all combinations of candidate space loops,
    permute them outermost, keep the rest as time loops (original order),
    filter by legality.
    """
    rec.validate()
    cands = candidate_space_loops(rec)
    deps = rec.dependences()
    out: list[SystolicSchedule] = []
    for ndim in range(1, max_space_dims + 1):
        for combo in itertools.permutations(cands, ndim):
            space = tuple(combo)
            time = tuple(l for l in rec.loops if l not in space)
            if not time:
                # need at least one time loop to sequence the computation
                continue
            if not _legal(rec, space, time):
                continue
            comm = tuple((d, classify_comm(d, space, time)) for d in deps)
            out.append(
                SystolicSchedule(
                    recurrence_name=rec.name,
                    space_loops=space,
                    time_loops=time,
                    comm=comm,
                )
            )
    # dedupe 1-D schedules that alias 2-D ones with identical comm patterns
    uniq: dict[tuple, SystolicSchedule] = {}
    for s in out:
        uniq[(s.space_loops, s.time_loops)] = s
    return list(uniq.values())
