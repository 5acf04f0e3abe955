"""The port's sharding rules (``parallel/sharding.py``), logical spec trees
(``param_logical`` / ``cache_logical`` / ``batch_logical`` of every
family, ``opt_state_logical``), sharded restore and ``launch/mesh.py``
against the JAX package's, in this process on the CPU.

* the reference's own ``tests/test_sharding.py`` cases, each run on both
  packages: ``guard_spec`` clamping (a spec longer than the shape,
  composite axes, a ragged dimension), ``mesh_context`` nesting and
  restore on exit (through an exception too), ``None`` clearing the
  context, the default and hierarchical rules, ``MeshCtx.spec``,
  ``logical_to_sharding``, ``spec_tree_to_shardings`` over a mixed tree
  and ``logical_spec_tree``; the port's ``constrain`` returns its input
  with a context as well as without;
* every registered arch's SMOKE parameter, cache and batch trees: the
  logical axes of each leaf, and the spec each resolves to under
  ``default_rules``, equal to the reference's leaf under the
  ``convert.py`` mapping (a stacked group's leading ``layers`` axis,
  replicated, taken off); the trees' structures and ranks equal the
  port's own parameters', cache's and pipeline batches';
* ``restore_checkpoint(shardings=...)`` onto a smaller mesh, and a spec
  naming an axis the mesh lacks refused;
* ``make_mesh_from_devices`` builds the reference's (data, model) shapes
  and ``make_production_mesh`` refuses too few logical devices.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import NamedSharding as JaxNamed  # noqa: E402
from jax.sharding import PartitionSpec as JaxP  # noqa: E402

from repro.compat import make_mesh as jax_make_mesh  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.optim import opt_state_logical as jax_opt_logical  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import opt_state_logical  # noqa: E402
from repro_torch.parallel import mesh as pm  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.parallel.mesh import P  # noqa: E402

AXES = ("data", "model")


@pytest.fixture
def meshes():
    """A (1, 1) mesh of each package: axis names are what the rules
    resolve, sizes only matter to guard_spec."""
    return (pm.make_mesh((1, 1), AXES),
            jax_make_mesh((1, 1), AXES, devices=jax.devices()[:1]))


class FakeMesh:
    shape = {"data": 2, "model": 16}


# ---------------------------------------------------------------------------
# guard_spec, the context, the rules (the reference's test_sharding cases)
# ---------------------------------------------------------------------------

GUARD_CASES = [
    (("data", "model"), (8, 16)),
    (("model", "model"), (4,)),
    (("data", "model"), (8, 24)),
    ((("data", "model"), None), (64, 3)),
    ((("data", "model"), "data"), (48, 5)),
    ((None, "model", "data"), (3, 32, 2)),
]


@pytest.mark.parametrize("spec,shape", GUARD_CASES)
def test_guard_spec_equals_reference(spec, shape):
    want = JS.guard_spec(FakeMesh(), JaxP(*spec), shape)
    got = TS.guard_spec(FakeMesh(), P(*spec), shape)
    assert isinstance(got, P)
    assert tuple(got) == tuple(want)


def test_axis_size_on_a_real_mesh(meshes):
    mesh, _ = meshes
    assert TS._axis_size(mesh, "model") == 1
    assert TS._axis_size(mesh, None) == 1
    assert TS._axis_size(mesh, ("data", "model")) == 1
    with pm.logical_devices(8):
        m = pm.make_mesh((2, 4), AXES)
    assert TS._axis_size(m, ("data", "model")) == 8
    assert tuple(TS.guard_spec(m, P("model", "data"), (6, 4))) == (None,
                                                                  "data")


def test_mesh_context_nests_and_restores(meshes):
    for mod, mesh in zip((TS, JS), meshes):
        assert mod.current_mesh() is None
        with mod.mesh_context(mesh) as outer:
            assert mod.current_mesh() is outer and outer.mesh is mesh
            inner_rules = mod.hierarchical_rules()
            with mod.mesh_context(mesh, rules=inner_rules) as inner:
                assert mod.current_mesh() is inner
                assert inner.rules is inner_rules
            assert mod.current_mesh() is outer
        assert mod.current_mesh() is None


def test_mesh_context_restores_through_exceptions(meshes):
    for mod, mesh in zip((TS, JS), meshes):
        with pytest.raises(RuntimeError, match="boom"):
            with mod.mesh_context(mesh):
                raise RuntimeError("boom")
        assert mod.current_mesh() is None


def test_mesh_context_none_clears(meshes):
    for mod, mesh in zip((TS, JS), meshes):
        with mod.mesh_context(mesh):
            with mod.mesh_context(None) as ctx:
                assert ctx is None and mod.current_mesh() is None
            assert mod.current_mesh() is not None


def test_use_mesh_ctx_sets_and_clears(meshes):
    mesh, _ = meshes
    ctx = TS.MeshCtx(mesh, TS.default_rules())
    TS.use_mesh_ctx(ctx)
    try:
        assert TS.current_mesh() is ctx
    finally:
        TS.use_mesh_ctx(None)
    assert TS.current_mesh() is None


@pytest.mark.parametrize("kw", [{}, {"fsdp": False}, {"multi_pod": True},
                                {"multi_pod": True, "fsdp": False}])
def test_default_rules_equal_reference(kw):
    assert TS.default_rules(**kw) == JS.default_rules(**kw)


@pytest.mark.parametrize("kw", [{}, {"outer_axes": ("x", "y"), "fsdp": True},
                                {"fsdp": True}])
def test_hierarchical_rules_equal_reference(kw):
    assert TS.hierarchical_rules(**kw) == JS.hierarchical_rules(**kw)


def test_ctx_spec_resolves_logical_names(meshes):
    for mod, mesh in zip((TS, JS), meshes):
        with mod.mesh_context(mesh) as ctx:
            assert tuple(ctx.spec("batch", None, "ff")) == ("data", None,
                                                            "model")
            assert tuple(ctx.spec("no_such_axis")) == (None,)


def test_logical_to_sharding_under_context(meshes):
    mesh, jmesh = meshes
    assert TS.logical_to_sharding(("batch", None)) is None
    with TS.mesh_context(mesh):
        s = TS.logical_to_sharding(("batch", None))
    with JS.mesh_context(jmesh):
        w = JS.logical_to_sharding(("batch", None))
    assert isinstance(s, TS.NamedSharding) and isinstance(w, JaxNamed)
    assert s.mesh is mesh and s.mesh.shape == dict(w.mesh.shape)
    assert tuple(s.spec) == tuple(w.spec) == ("data", None)


def test_spec_tree_to_shardings_mixed_tree(meshes):
    mesh, _ = meshes
    out = TS.spec_tree_to_shardings(mesh, {
        "w": P("data", "model"),
        "nested": {"b": P(None), "scalar": P()},
        "layers": [P("model"), P(None, "data")],
        "passthrough": None,
    })
    assert isinstance(out["w"], TS.NamedSharding)
    assert tuple(out["w"].spec) == ("data", "model")
    assert tuple(out["nested"]["b"].spec) == (None,)
    assert tuple(out["nested"]["scalar"].spec) == ()
    assert [tuple(s.spec) for s in out["layers"]] == [("model",),
                                                      (None, "data")]
    assert out["passthrough"] is None
    # NamedSharding is one leaf of the port's trees
    assert len(tree.leaves(out)) == 6


def test_logical_spec_tree_mixed_logical_and_none(meshes):
    for mod, mesh in zip((TS, JS), meshes):
        with mod.mesh_context(mesh) as ctx:
            specs = mod.logical_spec_tree(ctx, {"w": ("d_model", "ff"),
                                                "b": (None,)})
            assert tuple(specs["w"]) == ("data", "model")
            assert tuple(specs["b"]) == (None,)


def test_constrain_returns_its_input(meshes):
    mesh, _ = meshes
    x = torch.ones(4, 4)
    assert TS.constrain(x, "batch", "ff") is x
    with TS.mesh_context(mesh):
        assert TS.constrain(x, "batch", "ff") is x


# ---------------------------------------------------------------------------
# logical spec trees of every family
# ---------------------------------------------------------------------------

def _spec_leaves(node, prefix=""):
    """{path: tuple leaf} of a spec tree (dicts and lists; tuples are
    leaves)."""
    if isinstance(node, dict):
        out = {}
        for k in node:
            out.update(_spec_leaves(node[k], f"{prefix}/{k}" if prefix
                                    else str(k)))
        return out
    if isinstance(node, list):
        out = {}
        for i, v in enumerate(node):
            out.update(_spec_leaves(v, f"{prefix}/{i}"))
        return out
    return {prefix: node}


def _reference_path(cfg, path: str) -> tuple[str, bool]:
    """The reference's leaf path of the port's ``path`` (convert.py's
    mapping), and whether it carries a stacked ``layers`` axis."""
    parts = path.split("/")
    if parts[0] == "layers":
        group = "dense_layers" if (cfg.family != "moe" or int(parts[1])
                                   < cfg.moe_first_dense) else "moe_layers"
        return "/".join([group] + parts[2:]), True
    if parts[0] in ("trunk", "enc_layers", "dec_layers"):
        return "/".join([parts[0]] + parts[2:]), True
    return path, False


def _resolved(mod, mesh, tree_):
    with mod.mesh_context(mesh) as ctx:
        return _spec_leaves(mod.logical_spec_tree(ctx, tree_))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_equals_reference(arch, meshes):
    mesh, jmesh = meshes
    cfg = get_smoke_config(arch)
    api = build_model(cfg, "cpu")
    japi = jax_build(jax_smoke(arch))
    got = _spec_leaves(api.param_logical())
    want = _spec_leaves(japi.param_logical())
    got_p = _resolved(TS, mesh, api.param_logical())
    want_p = _resolved(JS, jmesh, japi.param_logical())
    seen = set()
    for path, axes in got.items():
        ref, stacked = _reference_path(cfg, path)
        seen.add(ref)
        lead = ("layers",) if stacked else ()
        assert lead + axes == want[ref], path
        assert (None,) * stacked + tuple(got_p[path]) == tuple(
            want_p[ref]), path
    assert seen == set(want)
    # the tree is the port's parameter tree, leaf for leaf and rank for rank
    params = api.init(torch.Generator().manual_seed(0))
    assert tree.paths(params) == sorted(got, key=tree.paths(params).index)
    assert set(tree.paths(params)) == set(got)
    for path, leaf in zip(tree.paths(params), tree.leaves(params)):
        assert len(got[path]) == leaf.dim(), path


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_equals_reference(arch, meshes):
    mesh, jmesh = meshes
    cfg = get_smoke_config(arch)
    api = build_model(cfg, "cpu")
    japi = jax_build(jax_smoke(arch))
    assert api.cache_logical() == japi.cache_logical()
    assert _resolved(TS, mesh, api.cache_logical()) == {
        k: tuple(v) for k, v in _resolved(JS, jmesh,
                                          japi.cache_logical()).items()}
    cache = api.init_cache(2, 16)
    specs = _spec_leaves(api.cache_logical())
    assert set(cache) == set(specs)
    for k, v in cache.items():
        assert len(specs[k]) == v.dim(), k


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_logical_equals_reference(arch, meshes):
    mesh, jmesh = meshes
    cfg = get_smoke_config(arch)
    api = build_model(cfg, "cpu")
    japi = jax_build(jax_smoke(arch))
    assert api.batch_logical() == japi.batch_logical()
    assert _resolved(TS, mesh, api.batch_logical()) == {
        k: tuple(v) for k, v in _resolved(JS, jmesh,
                                          japi.batch_logical()).items()}
    seq = cfg.vlm_patches + 16 if cfg.family == "vlm" else 16
    batch = SyntheticPipeline(cfg, ShapeSpec("t", "train", seq, 2)).batch(0)
    assert set(batch) == set(api.batch_logical())
    for k, v in batch.items():
        assert len(api.batch_logical()[k]) == v.ndim, k


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_opt_state_logical_equals_reference(arch):
    cfg = get_smoke_config(arch)
    got = opt_state_logical(build_model(cfg, "cpu").param_logical())
    want = jax_opt_logical(jax_build(jax_smoke(arch)).param_logical())
    assert got.count == want.count == ()
    assert got.m is got.v
    assert _spec_leaves(got.m)["embed"] == _spec_leaves(want.m)["embed"]


def test_trainer_resolves_its_spec_trees_under_the_mesh(tmp_path):
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke_config("olmoe-1b-7b")
    with pm.logical_devices(4):
        mesh = pm.make_mesh((2, 2), AXES)
        t = Trainer(cfg, ShapeSpec("t", "train", 16, 4), ckpt_dir=str(
            tmp_path), tcfg=TrainConfig(), mesh=mesh, device="cpu")
    ps = _spec_leaves(tree.tree_map(lambda s: s.spec, t.param_shardings))
    assert ps["layers/1/moe/wg"] == P("model", "data", None)
    assert ps["embed"] == P("model", "data")
    assert t.opt_shardings.count.spec == P()
    assert t.batch_shardings["tokens"].spec == P("data", None)
    assert all(s.mesh is mesh for s in tree.leaves(t.param_shardings))
    t.rebuild(None)
    assert t.param_shardings is None and t.batch_shardings is None


# ---------------------------------------------------------------------------
# sharded restore, production meshes
# ---------------------------------------------------------------------------

def test_restore_onto_a_smaller_mesh(tmp_path):
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint

    tree_ = {"w": torch.arange(24, dtype=torch.float32).reshape(6, 4),
             "b": [torch.ones(3, dtype=torch.bfloat16)]}
    save_checkpoint(str(tmp_path), 1, tree_)
    with pm.logical_devices(8):
        mesh4 = pm.make_mesh((2, 2), AXES)
        shardings = {"w": TS.NamedSharding(mesh4, P("data", "model")),
                     "b": [TS.NamedSharding(mesh4, P("model"))]}
        out = restore_checkpoint(str(tmp_path), 1, tree_, shardings=shardings)
        assert torch.equal(out["w"], tree_["w"])
        assert torch.equal(out["b"][0], tree_["b"][0])
        assert out["w"].device == mesh4.devices.flat[0]
        bad = {"w": TS.NamedSharding(mesh4, P("pod", None)),
               "b": [TS.NamedSharding(mesh4, P())]}
        with pytest.raises(ValueError, match="lacks"):
            restore_checkpoint(str(tmp_path), 1, tree_, shardings=bad)
        with pytest.raises(ValueError, match="shardings for"):
            restore_checkpoint(str(tmp_path), 1, tree_,
                               shardings={"w": shardings["w"]})


@pytest.mark.parametrize("n,model_parallel", [(8, 2), (4, 2), (8, 16),
                                              (6, 4), (1, 16), (12, 8)])
def test_make_mesh_from_devices_shapes(n, model_parallel):
    """The reference's shapes: the model axis halved until it divides the
    device count, data = n // model (``repro.launch.mesh``)."""
    with pm.logical_devices(n):
        devs = pm.devices()
        mesh = LM.make_mesh_from_devices(devs, model_parallel=model_parallel)
    want = {(8, 2): (4, 2), (4, 2): (2, 2), (8, 16): (1, 8), (6, 4): (3, 2),
            (1, 16): (1, 1), (12, 8): (3, 4)}[(n, model_parallel)]
    assert mesh.shape == dict(zip(AXES, want))
    assert list(mesh.devices.flat) == devs[:mesh.devices.size]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_needs_its_devices(multi_pod):
    n = 512 if multi_pod else 256
    with pm.logical_devices(8):
        with pytest.raises(ValueError, match="needs"):
            LM.make_production_mesh(multi_pod=multi_pod)
    with pm.logical_devices(n):
        mesh = LM.make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                          else {"data": 16, "model": 16})


def test_launcher_mesh_builds_the_production_mesh(tmp_path):
    """``launch/train.py --mesh single`` builds ``make_production_mesh``,
    which refuses the CPU's one logical device as the reference's does
    on too few devices; there is no ``NotImplementedError`` left."""
    from repro_torch.launch import train as launch_train

    with pytest.raises(ValueError, match="needs 256 devices"):
        launch_train.main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps",
                           "1", "--device", "cpu", "--mesh", "single",
                           "--ckpt-dir", str(tmp_path)])
    assert dataclasses.is_dataclass(TS.NamedSharding)
