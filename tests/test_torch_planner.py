"""The port's copy of the planner gives the reference planner's plans.

For each request — the full-width serving shapes of qwen1.5-0.5b, the
registry smoke sizes, ragged and degenerate shapes — the port's
``resolve``/``best_plan`` must agree with ``repro.core`` under the
modelled policy: the same feasibility, the same kernel blocks and the
same plan description.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import autotune as jax_autotune  # noqa: E402
from repro.core.mapper import Target as JaxTarget  # noqa: E402
from repro.core.mapper import best_plan as jax_best_plan  # noqa: E402
from repro.kernels import registry as jax_registry  # noqa: E402
from repro.kernels.planned import PLANNED_TARGET as JAX_TARGET  # noqa: E402
from repro_torch.core import autotune  # noqa: E402
from repro_torch.core.mapper import Target, best_plan  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.planned import PLANNED_TARGET  # noqa: E402

REQUESTS = (
    ("mm", (12, 1024, 1024), "bfloat16"),
    ("mm", (12, 2816, 1024), "bfloat16"),
    ("mm", (12, 1024, 2816), "bfloat16"),
    ("mm", (4, 151936, 1024), "bfloat16"),
    ("mm", (1, 151936, 1024), "bfloat16"),
    ("mm", (4, 1024, 1024), "bfloat16"),
    ("bmm", (64, 1, 128, 64), "bfloat16"),
    ("bmm", (64, 1, 64, 128), "bfloat16"),
    ("bmm", (16, 12, 12, 64), "bfloat16"),
    ("bmm", (16, 12, 64, 12), "bfloat16"),
    ("mm", (256, 256, 256), "float32"),
    ("mm", (61, 126, 37), "int8"),
    ("mm", (1, 1, 1), "float32"),
    ("bmm", (4, 128, 128, 64), "int16"),
    ("bmm", (3, 5, 7, 11), "int32"),
    ("mm", (0, 8, 8), "float32"),
)


def _same(port, ref):
    assert (port is None) == (ref is None)
    if ref is None:
        return
    assert port.feasible == ref.feasible
    assert port.partition.block == ref.partition.block
    assert port.backend == ref.backend == "pallas"
    assert port.describe() == ref.describe()


@pytest.mark.parametrize("kind,shape,dtype", REQUESTS,
                         ids=[f"{k}{s}-{d}" for k, s, d in REQUESTS])
def test_resolve_matches_reference(kind, shape, dtype):
    port = autotune.resolve(autotune.PlanRequest(
        kind, shape, dtype, PLANNED_TARGET, autotune.PlanPolicy()))
    ref = jax_autotune.resolve(jax_autotune.PlanRequest(
        kind, shape, dtype, JAX_TARGET,
        jax_autotune.PlanPolicy(mode="modelled")))
    _same(port, ref)


@pytest.mark.parametrize("mesh", [(1, 8), (2, 4), (4, 4)])
def test_best_plan_matches_reference_on_other_meshes(mesh):
    for kind, shape, dtype in REQUESTS[:10]:
        port = best_plan(registry.get(kind).builder(*shape, dtype),
                         Target(name="t", mesh_shape=mesh))
        ref = jax_best_plan(jax_registry.get(kind).builder(*shape, dtype),
                            JaxTarget(name="t", mesh_shape=mesh))
        _same(port, ref)


def test_targets_are_identical():
    assert PLANNED_TARGET.mesh_shape == JAX_TARGET.mesh_shape
    assert PLANNED_TARGET.name == JAX_TARGET.name


@dataclasses.dataclass(frozen=True)
class _HierarchicalTarget(Target):
    """A target with an outer mesh, which the port does not plan yet."""

    outer_shape: tuple = (2, 2)


def test_unported_policies_and_plan_kinds_raise():
    for mode in ("fastest", "cached", "measured"):
        with pytest.raises(ValueError, match="modelled"):
            autotune.PlanPolicy(mode=mode)
    hier = _HierarchicalTarget(name="h", mesh_shape=(1, 8))
    rec = registry.get("mm").builder(8, 8, 8, "float32")
    with pytest.raises(NotImplementedError, match="hierarchical"):
        best_plan(rec, hier)
    # resolve() passes the refusal on: it is not an infeasible shape
    with pytest.raises(NotImplementedError, match="hierarchical"):
        autotune.resolve(autotune.PlanRequest(
            "mm", (8, 8, 8), "float32", hier))
    assert autotune.counters() == {"hits": 0, "misses": 0,
                                   "measure_calls": 0, "table_errors": 0}
    assert autotune.resolve(autotune.PlanRequest(
        "fir", (64, 4), "float32", PLANNED_TARGET)) is None
