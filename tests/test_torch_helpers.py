"""The last helpers of the JAX package that no model path calls, ported and
held against their JAX originals on seeded numpy inputs, float32, CPU:

- ``ops/geometry.py``: ``boxes_to_corners_3d``, ``points_in_boxes``,
  ``_height_overlap``, ``boxes_iou3d``, ``bbox3d_overlaps_giou``;
- ``models/vfe.py``: ``PFNLayerV2`` (eval and train mode) and
  ``DynamicPillarVFESimple2D.build_point_features``;
- ``ops/active_site.py``, the unbatched forms: ``conv_neighbor_table``,
  ``gather_taps``, ``invert_taps``, ``gather_taps_inv``, ``conv3x3_as``,
  ``densify``, ``densify_packed``, ``sparsify``.

The cases and shapes are those of ``tests/test_geometry.py``,
``tests/test_active_site.py`` and ``tests/test_vfe.py``. Tolerances: float
values and gradients rel-L2 <= 1e-5 (float32 summation order over at most a
few hundred terms, measured near 1e-7); index tables, masks, counts and
memberships bit-equal (integer and boolean functions of the same inputs).
The gradients of ``gather_taps_inv``, ``densify``, ``densify_packed`` and
``conv3x3_as`` are held against the JAX ``custom_vjp``s'. Last, the port
defines every public name of the three JAX modules.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radardistill_tpu.models.vfe as jvfe
import radardistill_tpu.ops.active_site as jasx
import radardistill_tpu.ops.geometry as jgeo
import radardistill_tpu_torch.models.vfe as tvfe
import radardistill_tpu_torch.ops.active_site as tasx
import radardistill_tpu_torch.ops.geometry as tgeo
from radardistill_tpu_torch.convert import load_jax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.shape(got) == np.shape(want)
    assert _rel_l2(got, want) <= tol


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _boxes(rng, n, spread=4.0):
    """Random boxes [x, y, z, dx, dy, dz, heading] near each other."""
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


# ------------------------------------------------------------------ geometry


@pytest.mark.parametrize("seed", [0, 1])
def test_boxes_to_corners_3d(seed):
    b = _boxes(np.random.RandomState(seed), 20)
    _close(tgeo.boxes_to_corners_3d(torch.from_numpy(b)),
           jax.jit(jgeo.boxes_to_corners_3d)(jnp.asarray(b)))


@pytest.mark.parametrize("seed", [0, 1])
def test_points_in_boxes(seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    b = _boxes(rng, 12)
    _equal(tgeo.points_in_boxes(torch.from_numpy(pts), torch.from_numpy(b)),
           jax.jit(jgeo.points_in_boxes)(jnp.asarray(pts), jnp.asarray(b)))


def test_height_overlap():
    rng = np.random.RandomState(2)
    a, b = _boxes(rng, 9), _boxes(rng, 11)
    _close(tgeo._height_overlap(torch.from_numpy(a), torch.from_numpy(b)),
           jgeo._height_overlap(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boxes_iou3d(seed):
    rng = np.random.RandomState(seed)
    a, b = _boxes(rng, 16, 2.0), _boxes(rng, 13, 2.0)
    a[0], b[0] = a[1], a[1]  # one identical pair: IoU 1
    got = tgeo.boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b))
    want = jax.jit(jgeo.boxes_iou3d)(jnp.asarray(a), jnp.asarray(b))
    _close(got, want)
    assert float(got.max()) <= 1.0 + 1e-6 and (got > 0).sum() > 5


@pytest.mark.parametrize("seed", [0, 1])
def test_bbox3d_overlaps_giou_and_its_gradient(seed):
    rng = np.random.RandomState(seed)
    gt = _boxes(rng, 32, 2.0)
    pred = gt + rng.normal(0, 0.5, gt.shape).astype(np.float32)
    pred[:, 3:6] = np.abs(pred[:, 3:6]) + 0.1
    pred[0] = gt[0]  # the identity: GIoU 1
    p = torch.from_numpy(pred).requires_grad_()
    got = tgeo.bbox3d_overlaps_giou(p, torch.from_numpy(gt))
    want = jax.jit(jgeo.bbox3d_overlaps_giou)(jnp.asarray(pred), jnp.asarray(gt))
    _close(got, want)
    w = rng.randn(32).astype(np.float32)
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), p)
    gw = jax.jit(jax.grad(lambda q: jnp.sum(jgeo.bbox3d_overlaps_giou(q, jnp.asarray(gt)) * w)))(
        jnp.asarray(pred))
    _close(g, gw)


# ----------------------------------------------------------------------- VFE

PC = (-8.0, -8.0, -5.0, 8.0, 8.0, 3.0)
VOX = (0.5, 0.5, 8.0)
GRID = (32, 32)


def _points(seed, n=300, n_valid=250):
    from radardistill_tpu_torch.ops import voxelize

    rng = np.random.RandomState(seed)
    pts = rng.uniform(-9, 9, (1, n, 5)).astype(np.float32)
    mask = np.zeros((1, n), bool)
    mask[:, :n_valid] = True
    coords, in_range = voxelize.compute_pillar_coords(torch.from_numpy(pts[..., :2]), PC, VOX,
                                                      GRID)
    valid = torch.from_numpy(mask) & in_range
    ids = voxelize.pillar_ids(coords, valid, GRID)
    return pts, valid, ids


@pytest.mark.parametrize("seed", [0, 1])
def test_build_point_features(seed):
    pts, valid, ids = _points(seed)
    jm = jvfe.DynamicPillarVFESimple2D(num_filters=(32,), voxel_size=VOX, point_cloud_range=PC,
                                       grid_size=GRID)
    tm = tvfe.DynamicPillarVFESimple2D((32,), VOX, PC, GRID, num_point_features=5)
    got = tm.build_point_features(torch.from_numpy(pts), valid, ids)
    want = jax.jit(jm.build_point_features)(jnp.asarray(pts), jnp.asarray(valid.numpy()),
                                            jnp.asarray(ids.numpy()))
    _close(got, want)
    assert not got[~valid].any()


@pytest.mark.parametrize("last, train", [(False, False), (True, False), (False, True)])
def test_pfn_layer_v2(last, train):
    pts, valid, ids = _points(3)
    rng = np.random.RandomState(4)
    feats = rng.randn(*pts.shape[:2], 10).astype(np.float32)
    jm = jvfe.PFNLayerV2(out_channels=32, last_layer=last)
    jargs = (jnp.asarray(feats), jnp.asarray(ids.numpy()), jnp.asarray(valid.numpy()), GRID)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, *a: jm.init(k, *a, GRID, False))(
        jax.random.PRNGKey(0), *jargs[:3]))
    n = 32 if last else 16
    variables["params"]["linear"]["kernel"] = rng.randn(10, n).astype(np.float32) * 0.3
    variables["params"]["norm"] = {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                                   "bias": rng.uniform(-0.2, 0.2, n).astype(np.float32)}
    variables["batch_stats"]["norm"] = {"mean": rng.uniform(-0.1, 0.1, n).astype(np.float32),
                                        "var": rng.uniform(0.8, 1.2, n).astype(np.float32)}
    if train:
        want, _ = jax.jit(lambda v, *a: jm.apply(v, *a, GRID, True, mutable=["batch_stats"]))(
            variables, *jargs[:3])
    else:
        want = jax.jit(lambda v, *a: jm.apply(v, *a, GRID, False))(variables, *jargs[:3])
    tm = load_jax_variables(tvfe.PFNLayerV2(10, 32, last_layer=last), variables)
    tm.train(train)
    got = tm(torch.from_numpy(feats), ids, valid, GRID)
    _close(got[0], want[0])
    if last:
        _close(got[1], want[1])
        assert tuple(got[1].shape) == (1, GRID[1], GRID[0], 32)
    else:
        assert got[1] is None and want[1] is None


# ------------------------------------------------------------ active sites

H = W = 24
CAP = 64


def _active(seed, n_active=40, h=H, w=W, cap=CAP):
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.choice(h * w, size=n_active, replace=False)).astype(np.int32)
    uids = np.full(cap, h * w, np.int32)
    uids[:n_active] = ids
    return rng, uids


def _tables(seed, stride):
    """(rng, input uids, output uids, nb, msk) of one sample, by the JAX
    package's functions, and the same through the port's."""
    rng, uids = _active(seed)
    hw_out = (H // stride) * (W // stride)
    if stride == 1:
        out = uids
    else:
        out = np.array(jax.jit(jasx.downsample_active, static_argnums=(1, 2))(
            jnp.asarray(uids), (H, W), CAP)[0])
    grid = jax.jit(jasx.site_index_grid, static_argnums=(1, 2))(jnp.asarray(uids), H * W, CAP)
    jnb, jmsk = jax.jit(jasx.conv_neighbor_table, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(out), grid, (H, W), W // stride, stride, CAP)
    tgrid = tasx.site_index_grid(torch.from_numpy(uids)[None], H * W, CAP)[0]
    tnb, tmsk = tasx.conv_neighbor_table(torch.from_numpy(out), tgrid, (H, W), W // stride,
                                         stride, CAP)
    assert (out < hw_out).sum() > 10
    return rng, uids, out, (jnb, jmsk), (tnb, tmsk)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_neighbor_table(stride):
    _, _, _, (jnb, jmsk), (tnb, tmsk) = _tables(0, stride)
    assert tnb.dtype == torch.int32
    _equal(tnb, jnb)
    _equal(tmsk, jmsk)


@pytest.mark.parametrize("stride", [1, 2])
def test_invert_taps(stride):
    _, _, _, (jnb, jmsk), (tnb, tmsk) = _tables(1, stride)
    jinv, jimsk = _jax_invert(jnb, jmsk)
    tinv, timsk = tasx.invert_taps(tnb, tmsk, CAP)
    _equal(tinv, jinv)
    _equal(timsk, jimsk)


def _jax_invert(nb, msk):
    return jax.jit(jasx.invert_taps, static_argnums=2)(nb, msk, CAP)


def _feats(rng, n, c=8):
    f = rng.randn(CAP, c).astype(np.float32)
    f[n:] = 0.0
    return f


def test_gather_taps():
    rng, uids, _, (jnb, jmsk), (tnb, tmsk) = _tables(2, 1)
    f = _feats(rng, int((uids < H * W).sum()))
    _close(tasx.gather_taps(torch.from_numpy(f), tnb, tmsk), jasx.gather_taps(jnp.asarray(f),
                                                                              jnb, jmsk))


@pytest.mark.parametrize("stride", [1, 2])
def test_gather_taps_inv_and_its_gradient(stride):
    rng, uids, _, (jnb, jmsk), (tnb, tmsk) = _tables(3, stride)
    jinv, jimsk = _jax_invert(jnb, jmsk)
    tinv, timsk = tasx.invert_taps(tnb, tmsk, CAP)
    f = _feats(rng, int((uids < H * W).sum()))
    cot = rng.randn(9, CAP, 8).astype(np.float32)
    ft = torch.from_numpy(f).requires_grad_()
    got = tasx.gather_taps_inv(ft, tnb, tmsk, tinv, timsk)
    want, vjp = jax.vjp(lambda x: jasx.gather_taps_inv(x, jnb, jmsk, jinv, jimsk), jnp.asarray(f))
    _close(got, want)
    (g,) = torch.autograd.grad(got, ft, torch.from_numpy(cot))
    _close(g, vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("stride, with_inv", [(1, True), (2, True), (1, False)])
def test_conv3x3_as_and_its_gradients(stride, with_inv):
    rng, uids, _, (jnb, jmsk), (tnb, tmsk) = _tables(4, stride)
    f = _feats(rng, int((uids < H * W).sum()))
    k = (rng.randn(3, 3, 8, 16) * 0.1).astype(np.float32)
    bias = (rng.randn(16) * 0.1).astype(np.float32)
    cot = rng.randn(CAP, 16).astype(np.float32)
    jinv = jimsk = tinv = timsk = None
    if with_inv:
        jinv, jimsk = _jax_invert(jnb, jmsk)
        tinv, timsk = tasx.invert_taps(tnb, tmsk, CAP)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (f, k, bias)]
    got = tasx.conv3x3_as(leaves[0], tnb, tmsk, leaves[1], leaves[2], inv=tinv, imsk=timsk)
    want, vjp = jax.vjp(lambda x, kk, bb: jasx.conv3x3_as(x, jnb, jmsk, kk, bb, inv=jinv,
                                                          imsk=jimsk),
                        jnp.asarray(f), jnp.asarray(k), jnp.asarray(bias))
    _close(got, want)
    for g, w in zip(torch.autograd.grad(got, leaves, torch.from_numpy(cot)),
                    vjp(jnp.asarray(cot))):
        _close(g, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_densify_and_its_gradient(seed):
    rng, uids = _active(seed)
    f = _feats(rng, int((uids < H * W).sum()))
    cot = rng.randn(H, W, 8).astype(np.float32)
    ft = torch.from_numpy(f).requires_grad_()
    dense, mask = tasx.densify(ft, torch.from_numpy(uids), (H, W))
    (jdense, jmask), vjp = jax.vjp(lambda x: jasx.densify(x, jnp.asarray(uids), (H, W)),
                                   jnp.asarray(f))
    _close(dense, jdense)
    _equal(mask, jmask)
    (g,) = torch.autograd.grad(dense, ft, torch.from_numpy(cot))
    _close(g, vjp((jnp.asarray(cot), np.zeros(jmask.shape, jax.dtypes.float0)))[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_densify_packed_and_its_gradient(seed):
    rng, uids = _active(seed)
    f = _feats(rng, int((uids < H * W).sum()))
    cot = rng.randn(H // 2, W // 2, 32).astype(np.float32)
    ft = torch.from_numpy(f).requires_grad_()
    dense, mask = tasx.densify_packed(ft, torch.from_numpy(uids), (H, W))
    (jdense, jmask), vjp = jax.vjp(lambda x: jasx.densify_packed(x, jnp.asarray(uids), (H, W)),
                                   jnp.asarray(f))
    _close(dense, jdense)
    _equal(mask, jmask)
    (g,) = torch.autograd.grad(dense, ft, torch.from_numpy(cot))
    _close(g, vjp((jnp.asarray(cot), np.zeros(jmask.shape, jax.dtypes.float0)))[0])


@pytest.mark.parametrize("cap", [64, 30])
def test_sparsify(cap):
    """A dense map and its mask back to a table; at cap 30 the 40 active
    sites overflow and the largest ids drop out."""
    rng, uids = _active(5)
    mask = np.zeros(H * W, bool)
    mask[uids[uids < H * W]] = True
    bev = rng.randn(H, W, 8).astype(np.float32)
    got = tasx.sparsify(torch.from_numpy(bev), torch.from_numpy(mask.reshape(H, W)), cap)
    want = jax.jit(jasx.sparsify, static_argnums=2)(jnp.asarray(bev),
                                                   jnp.asarray(mask.reshape(H, W)), cap)
    for g, w in zip(got, want):
        _equal(g, w)


# ------------------------------------------------------------ public names


def _public(path):
    tree = ast.parse(path.read_text())
    return sorted(n.name for n in tree.body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_"))


@pytest.mark.parametrize("mod", ["ops/geometry.py", "ops/active_site.py", "models/vfe.py"])
def test_port_defines_every_public_name(mod):
    port = {"ops/geometry.py": tgeo, "ops/active_site.py": tasx, "models/vfe.py": tvfe}[mod]
    missing = [n for n in _public(REPO / "radardistill_tpu" / mod) if not hasattr(port, n)]
    assert not missing
    if mod == "models/vfe.py":
        assert callable(tvfe.DynamicPillarVFESimple2D.build_point_features)
