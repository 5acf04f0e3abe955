"""Mapped graph + routing-aware PLIO assignment (paper §III-C, Algorithm 1)
— the port's copy of the parts of ``repro.core.plio`` the mapper and the
recurrence pipeline run.

The paper builds a *mapped graph* whose nodes are AIE cores (one per point of
the 2-D space-loop array) and I/O ports, with edges derived from the three
dependence kinds (read / flow / output).  Ports whose streams enter or leave
the array (boundary ports, zero-distance ports, output ports) become PLIO
ports; PLIOs live in row 0 of the array, and horizontal NoC congestion at
column *i* counts the streams that must cross that column:

    Cong_i^west = sum_{p in PLIOs, x in AIEs} W_i[p][x]
    W_i[p][x] = 1 if (p.col < i and x.col > i and (x,p) in E) or
                     (p.col > i and x.col < i and (p,x) in E) else 0

Feasibility: Cong_i^{west} <= RC_west and Cong_i^{east} <= RC_east for all i.
Algorithm 1 assigns each PLIO to the *median column* of its connected AIEs,
falling back to the nearest available column — balancing congestion.

TPU adaptation (DESIGN.md §2): the same machinery assigns each operand
stream of a chip-level systolic schedule to an ICI axis/direction; columns
become chip columns of the pod mesh and RC becomes the per-axis link budget.
The graph/algorithm code below is target-agnostic — it is exercised both on
the paper's 8x50 AIE geometry (tests reproduce §III-C behaviour) and on the
16x16 pod geometry by the mapper.
"""

from __future__ import annotations

import dataclasses

from .recurrence import UniformRecurrence
from .spacetime import SystolicSchedule


@dataclasses.dataclass(frozen=True)
class Node:
    """AIE core node at 2-D coordinates (row major: (row, col))."""

    row: int
    col: int

    @property
    def key(self) -> tuple[int, int]:
        return (self.row, self.col)


@dataclasses.dataclass
class Port:
    """An I/O port of the mapped graph (PLIO candidate).

    ``array``: tensor carried; ``direction``: 'in' | 'out';
    ``peers``: AIE node coordinates this port streams to/from;
    ``col``: assigned column (row is always 0, as in the paper).
    """

    name: str
    array: str
    direction: str
    peers: tuple[tuple[int, int], ...]
    col: int | None = None


@dataclasses.dataclass
class MappedGraph:
    """Nodes, neighbour edges, and boundary ports for one systolic design."""

    array_shape: tuple[int, int]
    nodes: list[Node]
    neighbour_edges: list[tuple[tuple[int, int], tuple[int, int], str]]
    ports: list[Port]


def build_mapped_graph(
    rec: UniformRecurrence,
    sched: SystolicSchedule,
    array_tiles: tuple[int, ...],
    ports_per_edge: int = 1,
    phys_shape: tuple[int, int] | None = None,
) -> MappedGraph:
    """Paper §III-C1: iterate space-loop coordinates, create one node per
    coordinate, derive edges from dependences, and create PLIO ports for
    output ports, boundary input ports, and zero-distance ports.

    ``ports_per_edge`` models packet-switch/broadcast sharing (Fig. 4): how
    many rows/cols share one physical PLIO port (1 = no sharing).
    1-D systolic chains are folded row-major onto ``phys_shape`` (the chain
    snakes across the physical grid, as AIE chains do on the 8x50 array).
    """
    if len(array_tiles) == 1 and phys_shape is not None:
        n = array_tiles[0]
        pcols = phys_shape[1]
        shape = (max(1, -(-n // pcols)), min(n, pcols))
    else:
        shape = tuple(array_tiles) + (1,) * (2 - len(array_tiles))
    rows, cols = shape[0], shape[1]
    nodes = [Node(r, c) for r in range(rows) for c in range(cols)]

    neighbour_edges: list[tuple[tuple[int, int], tuple[int, int], str]] = []
    ports: list[Port] = []
    pid = 0

    space = sched.space_loops

    def dep_dir(dep) -> tuple[int, int]:
        d0 = dep.dist(space[0]) if len(space) > 0 else 0
        d1 = dep.dist(space[1]) if len(space) > 1 else 0
        return (d0, d1)

    # Arrays already injected by a zero-space-distance ("local") read stream:
    # their window/halo read deps along space loops (stencil star points,
    # e.g. jacobi2d's G at i±1 or the 9-point star's i±2) are *reuse of
    # resident data* — intra-array neighbour hops, not new boundary streams.
    # They contribute neighbour edges below but no extra PLIO ports.
    locally_fed = {
        dep.array for dep, cls in sched.comm
        if cls == "local" and dep.kind == "read"
    }

    for dep, cls in sched.comm:
        d = dep_dir(dep)
        if cls in ("neighbour", "reduce") and d != (0, 0):
            # flow along the array: neighbour edges + boundary PLIOs.
            for n in nodes:
                src = (n.row, n.col)
                dst = (n.row + d[0], n.col + d[1])
                if 0 <= dst[0] < rows and 0 <= dst[1] < cols:
                    neighbour_edges.append((src, dst, dep.array))
            if dep.kind == "read" and dep.array in locally_fed:
                continue  # halo hop of resident data: edges only, no port
            # boundary injection side (for read/flow) or drain side (output)
            if dep.kind in ("read", "flow"):
                boundary = [
                    n.key
                    for n in nodes
                    if (d[0] > 0 and n.row == 0)
                    or (d[0] < 0 and n.row == rows - 1)
                    or (d[0] == 0 and d[1] > 0 and n.col == 0)
                    or (d[0] == 0 and d[1] < 0 and n.col == cols - 1)
                ]
                for group in _group(boundary, ports_per_edge):
                    ports.append(
                        Port(f"plio{pid}", dep.array, "in", tuple(group))
                    )
                    pid += 1
            else:  # output drains at the far boundary
                boundary = [
                    n.key
                    for n in nodes
                    if (d[0] > 0 and n.row == rows - 1)
                    or (d[0] < 0 and n.row == 0)
                    or (d[0] == 0 and d[1] > 0 and n.col == cols - 1)
                    or (d[0] == 0 and d[1] < 0 and n.col == 0)
                ]
                for group in _group(boundary, ports_per_edge):
                    ports.append(
                        Port(f"plio{pid}", dep.array, "out", tuple(group))
                    )
                    pid += 1
        elif cls == "local":
            # zero-distance: every PE needs its own stream of this array —
            # broadcast/packet-switch groups of columns share a port (Fig. 4)
            direction = "out" if dep.kind in ("flow", "output") else "in"
            # one port per column group (PLIOs live in row 0)
            col_groups = _group(
                [(0, c) for c in range(cols)], max(ports_per_edge, 1)
            )
            for group in col_groups:
                peers = tuple(
                    (r, c) for r in range(rows) for (_, c) in group
                )
                ports.append(
                    Port(f"plio{pid}", dep.array, direction, peers)
                )
                pid += 1
    return MappedGraph((rows, cols), nodes, neighbour_edges, ports)


def _group(items: list, k: int) -> list[list]:
    if k <= 1:
        return [[x] for x in items]
    return [items[i : i + k] for i in range(0, len(items), k)]


# ---------------------------------------------------------------------------
# Congestion model (faithful to the paper's W_i / Cong_i definitions)
# ---------------------------------------------------------------------------

def congestion(
    graph: MappedGraph, assignment: dict[str, int] | None = None
) -> tuple[list[int], list[int]]:
    """Per-column-boundary (west, east) congestion counts.

    Boundary *i* separates columns < i from columns >= i (i in 1..cols-1).
    A (port, AIE) edge crossing boundary i in either direction adds 1 to the
    respective direction's count — matching the paper's W_i[p][x].
    """
    cols = graph.array_shape[1]
    west = [0] * (cols + 1)
    east = [0] * (cols + 1)
    for port in graph.ports:
        pcol = assignment.get(port.name) if assignment else port.col
        if pcol is None:
            continue
        # one physical stream per distinct peer column: vertical distribution
        # within a column is free (the paper's W counts port->core streams;
        # broadcast/packet-switch sharing collapses same-column cores onto
        # one NoC stream, which is what the port grouping models)
        for xcol in sorted({c for (_, c) in port.peers}):
            lo, hi = sorted((pcol, xcol))
            for i in range(lo + 1, hi + 1):
                # stream travels from pcol to xcol (or back): it crosses
                # boundary i; direction west if moving toward lower columns
                if port.direction == "in":
                    (east if xcol > pcol else west)[i] += 1
                else:
                    (west if xcol > pcol else east)[i] += 1
    return west, east


def is_feasible(
    graph: MappedGraph,
    assignment: dict[str, int],
    rc_west: int,
    rc_east: int,
) -> bool:
    """Whether an assignment keeps both directions' congestion within
    the routing capacities."""
    west, east = congestion(graph, assignment)
    return max(west) <= rc_west and max(east) <= rc_east


# ---------------------------------------------------------------------------
# Algorithm 1 — Routing-Aware PLIO Assignment (faithful implementation)
# ---------------------------------------------------------------------------

def assign_plios(
    graph: MappedGraph,
    available_cols: list[int] | None = None,
    ports_per_col: int = 2,
) -> dict[str, int]:
    """Greedy median assignment (paper Algorithm 1).

    For each PLIO port, compute the median column of its connected AIE cores
    and take the nearest still-available column.  ``ports_per_col`` models
    multiple physical PLIO channels per column (the paper's VCK5000 exposes
    several per interface column).
    """
    cols = graph.array_shape[1]
    if available_cols is None:
        available_cols = list(range(cols))
    # multiset of free slots per column
    free: dict[int, int] = {c: ports_per_col for c in available_cols}

    assignment: dict[str, int] = {}
    for port in graph.ports:  # paper iterates ports in order
        s = sorted(c for (_, c) in port.peers)
        if not s:
            median = available_cols[0]
        else:
            median = s[len(s) // 2]
        target = _find_nearest(free, median)
        if target is None:
            raise RuntimeError(
                f"PLIO assignment infeasible: no free column for {port.name}"
            )
        assignment[port.name] = target
        free[target] -= 1
        if free[target] == 0:
            del free[target]
        port.col = target
    return assignment


def _find_nearest(free: dict[int, int], target: int) -> int | None:
    best, bestd = None, None
    for c in free:
        d = abs(c - target)
        if bestd is None or d < bestd or (d == bestd and c < best):
            best, bestd = c, d
    return best


def naive_assignment(graph: MappedGraph) -> dict[str, int]:
    """Baseline the paper implicitly compares against: pack PLIOs left to
    right in port order (what a solver does with no routing awareness)."""
    cols = graph.array_shape[1]
    return {p.name: i % cols for i, p in enumerate(graph.ports)}


# ---------------------------------------------------------------------------
# TPU adaptation: ICI axis assignment via the same congestion machinery
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisAssignment:
    """Which mesh axis each operand's collective travels over, plus the
    modelled per-axis load (bytes per step)."""

    stream_axis: dict  # array name -> mesh axis name
    axis_load: dict    # mesh axis name -> modelled bytes


def assign_collective_axes(
    rec: UniformRecurrence,
    sched: SystolicSchedule,
    mesh_axes: tuple[str, ...],
    mesh_shape: tuple[int, ...],
    bytes_per_elem: int,
) -> AxisAssignment:
    """PLIO-analogue for the chip level: balance operand streams over ICI
    axes.  Each 'neighbour'/'reduce' stream is pinned to the axis its space
    loop maps to (systolic direction); each 'local'/'broadcast' stream is
    placed greedily on the least-loaded axis — the median heuristic's
    balancing effect, adapted to axes instead of columns."""
    load: dict[str, float] = {a: 0.0 for a in mesh_axes}
    stream_axis: dict[str, str] = {}
    space = sched.space_loops
    loop_axis = {l: mesh_axes[i % len(mesh_axes)] for i, l in enumerate(space)}

    for dep, cls in sched.comm:
        # estimate stream footprint: operand size / array width along axis
        acc = next((a for a in rec.accesses if a.array == dep.array), None)
        size = bytes_per_elem
        if acc is not None:
            for l, _ in acc.index:
                if l is not None:
                    size *= rec.extent(l)
        if cls in ("neighbour", "reduce"):
            carrier = next((l for l in space if dep.dist(l) != 0), space[0])
            ax = loop_axis[carrier]
        else:
            ax = min(load, key=lambda a: load[a])
        stream_axis[dep.array] = ax
        idx = mesh_axes.index(ax)
        width = mesh_shape[idx] if idx < len(mesh_shape) else 1
        load[ax] += size / max(width, 1)
    return AxisAssignment(stream_axis, load)
