"""The modules of the port's dense-input route against the JAX package,
float32, CPU: the BEV scatter helpers of ``ops/voxelize.py``, the dense VFEs
(``DynamicPillarVFESimple2D`` with and without ``WITH_DISTANCE`` and on radar
points, ``DynamicPillarVFE``, ``MeanVFE``) at grid 96, the dense backbones
(``PillarRes18BackBone8x`` in eval and train mode and under ``INT8: true``,
``PillarBackBone8x``) at grid 64 and ``BaseBEVBackboneV1``, batch 2.

The JAX VFEs run under one ``jit`` together; every other JAX module runs op
by op: at these sizes a compile costs more than the test, and under one
``jit`` XLA's CPU backend turns the dynamic int8 path's ``x / sx`` into
another rounding (``tests/test_torch_chain.py``). Variables come from
``jax.eval_shape`` of the module's ``init``, kernels drawn from a numpy seed
and every BN statistic and scale and every bias from ``_perturb``, and are
bridged into the port (``convert.py``).

Tolerances: features rel-L2 <= 1e-4 (float32 summation order; measured
~1e-7), pillar ids and occupancy masks exactly equal, running statistics
after one train forward within 1e-5 (atol).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.models import backbone_sparse2d as jsp
from radardistill_tpu.models import bev_backbone as jbev
from radardistill_tpu.models import vfe as jvfe
from radardistill_tpu.ops import voxelize as jvox
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.data import synthetic
from radardistill_tpu_torch.models import backbone_sparse2d as sp
from radardistill_tpu_torch.models import bev_backbone as bev
from radardistill_tpu_torch.models import vfe
from radardistill_tpu_torch.ops import voxelize as vox
from tests.test_torch_slice import _perturb, _rel_l2

torch.set_num_threads(1)

GRID = 96
EXTENT = GRID * 0.075 / 2
PC_RANGE = (-EXTENT, -EXTENT, -5.0, EXTENT, EXTENT, 3.0)
VOXEL = (0.075, 0.075, 8.0)
GEO = dict(voxel_size=VOXEL, point_cloud_range=PC_RANGE, grid_size=(GRID, GRID))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _points(nf=5, n=1500):
    """Two seeded scenes (points partly out of range) and a padding tail."""
    pts = np.zeros((2, n + 64, nf), np.float32)
    mask = np.zeros((2, n + 64), bool)
    for i in range(2):
        s = synthetic.make_scene(i, num_lidar=n, num_radar=n, num_boxes=5, pc_range=PC_RANGE)
        p = s["points"] if nf == 5 else s["radar_points"]
        pts[i, :n], mask[i, :n] = p * np.float32(1.05), True  # 5% past the range
    return pts, mask


# ------------------------------------------------------------------ voxelize


def test_voxelize_helpers_match_jax():
    rng = np.random.RandomState(0)
    hw = GRID * GRID
    ids = rng.randint(0, 300, (2, 400)).astype(np.int32)
    ids[:, ::7] = hw  # the sentinel
    feats = rng.randn(2, 400, 4).astype(np.float32)
    xyz = rng.randn(2, 400, 3).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    g = (GRID, GRID)
    jmax = jax.vmap(lambda f, i: jvox.scatter_max_bev(f, i, g))(feats, ids)
    np.testing.assert_allclose(vox.scatter_max_bev(t(feats), t(ids), g).numpy(), jmax)
    jsum = jax.vmap(lambda f, i: jvox.scatter_sum_bev(f, i, g))(feats, ids)
    np.testing.assert_allclose(vox.scatter_sum_bev(t(feats), t(ids), g).numpy(), jsum,
                               rtol=1e-6, atol=1e-6)
    jcnt = jax.vmap(lambda i: jvox.pillar_count(i, g))(ids)
    np.testing.assert_array_equal(vox.pillar_count(t(ids), g).numpy(), jcnt)
    jback = jax.vmap(jvox.gather_from_bev)(jmax, ids)
    np.testing.assert_array_equal(
        vox.gather_from_bev(torch.from_numpy(np.asarray(jmax)), t(ids)).numpy(), jback)
    jmean = jax.vmap(lambda p, i: jvox.pillar_mean_per_point(p, i, g))(xyz, ids)
    np.testing.assert_allclose(vox.pillar_mean_per_point(t(xyz), t(ids), g).numpy(), jmean,
                               rtol=1e-5, atol=1e-6)
    # one sample alone, the JAX functions' own signature
    np.testing.assert_allclose(vox.scatter_max_bev(t(feats[0]), t(ids[0]), g).numpy(), jmax[0])


def test_scatter_max_gradient_is_shared_among_ties_as_jax():
    """Tied points of one pillar share the max's gradient evenly, in both
    packages."""
    ids = np.array([3, 3, 3, 5, 5, GRID * GRID], np.int32)
    feats = np.array([[1.0], [2.0], [2.0], [0.5], [-1.0], [9.0]], np.float32)
    w = np.random.RandomState(1).randn(GRID, GRID, 1).astype(np.float32)
    jg = jax.grad(lambda f: jnp.sum(jvox.scatter_max_bev(f, ids, (GRID, GRID)) * w))(feats)
    f = torch.from_numpy(feats).requires_grad_()
    (vox.scatter_max_bev(f, torch.from_numpy(ids), (GRID, GRID)) * torch.from_numpy(w)).sum() \
        .backward()
    np.testing.assert_allclose(f.grad.numpy(), jg, rtol=1e-6)
    assert f.grad[1, 0] == f.grad[2, 0] != 0 and f.grad[0, 0] == 0 == f.grad[5, 0]


# ---------------------------------------------------------------------- VFEs

VFES = {
    "simple2d": (jvfe.DynamicPillarVFESimple2D, vfe.DynamicPillarVFESimple2D, 5, {}),
    "simple2d-distance": (jvfe.DynamicPillarVFESimple2D, vfe.DynamicPillarVFESimple2D, 5,
                          {"with_distance": True}),
    "simple2d-radar": (jvfe.DynamicPillarVFESimple2D, vfe.DynamicPillarVFESimple2D, 6, {}),
    "dynamic": (jvfe.DynamicPillarVFE, vfe.DynamicPillarVFE, 5, {}),
}


def _numpy_variables(jm, *args, seed=0):
    """A variable tree of ``jm`` from ``jax.eval_shape`` of its ``init`` (no
    compile): kernels uniform on +-1 / sqrt(fan in), torch's conv default,
    every BN statistic and scale and every bias from ``_perturb``."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, False))
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict({k: dict(v) for k, v in shapes.items()})
    for k, v in flat.items():
        bound = 1.0 / np.sqrt(np.prod(v.shape[:-1])) if k[-1] == "kernel" else 0.0
        flat[k] = (rng.uniform(-bound, bound, v.shape) if bound else np.ones(v.shape)).astype(
            np.float32)
    return _perturb(flax.traverse_util.unflatten_dict(flat), seed=seed + 1)


@pytest.fixture(scope="module")
def vfe_runs():
    """Every VFE variant's eval and train forward in JAX, all under one
    ``jit`` (op by op, the segmented scans of the cluster mean cost more in
    small compiles than this one does)."""
    inputs, variables, modules = {}, {}, {}
    for name, (jcls, _, nf, kw) in VFES.items():
        inputs[name] = _points(nf)
        modules[name] = jcls(num_filters=(32,), **GEO, **kw)
        variables[name] = _numpy_variables(modules[name], *inputs[name])

    @jax.jit
    def run(variables, inputs):
        return {name: [modules[name].apply(variables[name], *inputs[name], train,
                                           mutable=["batch_stats"]) for train in (False, True)]
                for name in VFES}

    return inputs, variables, _np(run(variables, inputs))


@pytest.mark.parametrize("name", list(VFES))
def test_dense_vfe_matches_jax(vfe_runs, name):
    """Eval forward, train forward and the running statistics it leaves; the
    occupancy masks (the pillar ids) exactly equal."""
    inputs, variables, jruns = vfe_runs
    jcls, tcls, nf, kw = VFES[name]
    pts, mask = inputs[name]
    tm = load_jax_variables(tcls((32,), **GEO, num_point_features=nf, **kw), variables[name])
    assert tm.pfn_0.linear.weight.shape[1] == jvfe.vfe_input_dim(nf, {
        "WITH_DISTANCE": kw.get("with_distance", False),
        "USE_RELATIVE_XYZ": jcls is jvfe.DynamicPillarVFESimple2D})
    for train, (jout, upd) in zip((False, True), jruns[name]):
        tout = tm.train(train)(torch.from_numpy(pts), torch.from_numpy(mask))
        np.testing.assert_array_equal(tout[1].numpy(), jout[1])
        assert tout[1].sum() > 500
        assert _rel_l2(tout[0].detach().numpy(), jout[0]) <= 1e-4
    want = state_dict_from_jax(tm, dict(upd))
    for k, v in want.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_mean_vfe_matches_jax():
    pts, mask = _points(6)
    jm = jvfe.MeanVFE(**GEO)
    jbev, jmask = jm.apply({}, pts, mask, False)
    tm = vfe.MeanVFE(VOXEL, PC_RANGE, (GRID, GRID), 6)
    tbev, tmask = tm(torch.from_numpy(pts), torch.from_numpy(mask))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tbev.shape[-1] == tm.output_dim == 6 and tmask.sum() > 500
    assert _rel_l2(tbev.numpy(), np.asarray(jbev)) <= 1e-6


# ----------------------------------------------------------------- backbones


def _bev_input(c=32, seed=3, grid=64):
    """Backbone input at grid 64 (the JAX int8 convs run op by op)."""
    rng = np.random.RandomState(seed)
    mask = rng.rand(2, grid, grid) < 0.12
    return (rng.rand(2, grid, grid, c).astype(np.float32) * mask[..., None]), mask


BACKBONES = {
    "res18": (lambda: jsp.PillarRes18BackBone8x(), lambda: sp.PillarRes18BackBone8x()),
    "res18-int8": (lambda: jsp.PillarRes18BackBone8x(int8=True),
                   lambda: sp.PillarRes18BackBone8x(int8=True)),
    "plain": (lambda: jsp.PillarBackBone8x(), lambda: sp.PillarBackBone8x()),
}
OUT_KEYS = tuple(f"x_conv{n}" for n in range(1, 6)) + tuple(f"mask{n}" for n in range(1, 5))


@pytest.fixture(scope="module")
def backbone_variables():
    """One variable tree per backbone kind (the int8 one is the float one's).
    With these weights no int8 code of ``INT8: true`` lands within an ulp of
    a rounding boundary, so the two packages' codes agree and the int8 case
    holds the float tolerance; other weights may flip a few codes (the drift
    of two correct int8 chains, ROADMAP §3)."""
    x, m = _bev_input()
    return {name: _numpy_variables(BACKBONES[name][0](), x, m, seed=5)
            for name in ("res18", "plain")}


# INT8: true is the frozen teacher's path: eval only
CASES = [(n, t) for n in BACKBONES for t in (False, True) if not (t and n.endswith("int8"))]


@pytest.mark.parametrize("name,train", CASES,
                         ids=[f"{n}-{'train' if t else 'eval'}" for n, t in CASES])
def test_dense_backbone_matches_jax(backbone_variables, name, train):
    x, m = _bev_input()
    variables = backbone_variables[name.split("-")[0]]
    jout, upd = BACKBONES[name][0]().apply(variables, x, m, train, mutable=["batch_stats"])
    tm = load_jax_variables(BACKBONES[name][1](), variables).train(train)
    with torch.set_grad_enabled(train):
        tout = tm(torch.from_numpy(x), torch.from_numpy(m))
    for k in OUT_KEYS:
        got, want = tout[k].detach().numpy(), np.asarray(jout[k])
        assert got.shape == want.shape, k
        if k.startswith("mask"):
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(want).max() > 0 and _rel_l2(got, want) <= 1e-4, k
    if train:
        want = state_dict_from_jax(tm, _np(dict(upd)))
        stats = [k for k in want if "running_" in k]
        assert len(stats) >= 28
        for k in stats:
            np.testing.assert_allclose(tm.state_dict()[k].numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)


def test_base_bev_backbone_v1_matches_jax():
    rng = np.random.RandomState(6)
    x4 = rng.randn(2, 12, 12, 256).astype(np.float32)
    x5 = rng.randn(2, 6, 6, 256).astype(np.float32)
    jm = jbev.BaseBEVBackboneV1(layer_nums=(2, 2))
    variables = _perturb(_np(dict(jm.init(jax.random.PRNGKey(0), x4, x5, False))), seed=7)
    tm = load_jax_variables(bev.BaseBEVBackboneV1(layer_nums=(2, 2)), variables)
    for train in (False, True):
        (j2d, j8x), upd = jm.apply(variables, x4, x5, train, mutable=["batch_stats"])
        t2d, t8x = tm.train(train)(torch.from_numpy(x4), torch.from_numpy(x5))
        assert t2d.shape == (2, 12, 12, 256)
        assert _rel_l2(t2d.detach().numpy(), np.asarray(j2d)) <= 1e-4
        assert _rel_l2(t8x.detach().numpy(), np.asarray(j8x)) <= 1e-4
    want = state_dict_from_jax(tm, _np(dict(upd)))
    for k, v in want.items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
