"""The tile-sparse path of the port against the JAX package, float32, CPU:
the primitives of ``ops/tile_sparse.py`` (tile activity, the fixed-capacity
selection and its overflow flag, halo gathers, the scatter of the cores),
and ``PillarRes18BackBone8x_TileSparse`` against the JAX module (eval and
train mode, the running statistics, the gradient) and against the port's
dense ``PillarRes18BackBone8x`` on the same weights. The cases are those of
the JAX package's ``tests/test_tile_sparse.py`` and
``tests/test_tile_backbone.py``, whose parameter map is reused. Each JAX side
runs under one ``jit``.

Tolerances: selections and masks exactly equal; gathers and scatters exactly
equal (copies); backbone outputs rel-L2 <= 1e-5 against JAX and <= 1e-5
against the dense backbone when no tile overflows (the BatchNorm statistics
over the cores' active cells are those of the masked BatchNorm; measured
~1e-7), running statistics atol 1e-5, the gradient rel-L2 <= 1e-4.
"""

import jax
import numpy as np
import torch

from radardistill_tpu.models.backbone_sparse2d import PillarRes18BackBone8x as JDense
from radardistill_tpu.models.backbone_tile_sparse import PillarRes18BackBone8xTileSparse as JTile
from radardistill_tpu.ops import tile_sparse as jts
from radardistill_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from radardistill_tpu_torch.models import backbone_sparse2d as sp
from radardistill_tpu_torch.models import backbone_tile_sparse as bts
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.ops import tile_sparse as ts
from tests.test_tile_backbone import map_params, map_stats
from tests.test_torch_anchor import _numpy_variables
from tests.test_torch_slice import _rel_l2

torch.set_num_threads(1)

T = torch.from_numpy
GRID = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_tile_ops_match_jax():
    """Activity and selection (a capacity above, at and below the active
    count: the overflow flag), gathers with halo 0 and 2 and the scatter of
    the cores, on two samples."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 4).astype(np.float32)
    mask = np.zeros((2, 32, 32), bool)
    mask[0, 2:5, 3:6] = mask[0, 20:23, 25:29] = mask[1, 10:12, 1:3] = True
    mask[1, 31, 31] = True

    def run(x, mask):
        act = jts.tile_activity(mask, 8)
        sel = [jts.select_tiles(act, k) for k in (6, 4, 2)]
        ids, valid, _ = sel[0]
        patches = [jts.gather_tiles(x, ids, valid, 8, h) for h in (0, 2)]
        return act, sel, patches, jts.scatter_tiles(patches[0] * 2.0, ids, valid, x.shape)

    act, sel, patches, back = _np(jax.jit(run)(x, mask))
    tact = ts.tile_activity(T(mask), 8)
    np.testing.assert_array_equal(tact.numpy(), act)
    assert act.sum() == 4
    for k, (ids, valid, overflow) in zip((6, 4, 2), sel):
        tids, tvalid, tover = ts.select_tiles(tact, k)
        np.testing.assert_array_equal(tvalid.numpy(), valid)
        np.testing.assert_array_equal(tids.numpy()[valid], ids[valid])
        assert bool(tover) == bool(overflow) == (k < 4)
    tids, tvalid, _ = ts.select_tiles(tact, 6)
    for h, want in zip((0, 2), patches):
        np.testing.assert_array_equal(ts.gather_tiles(T(x), tids, tvalid, 8, h).numpy(), want)
    got = ts.scatter_tiles(T(patches[0]) * 2.0, tids, tvalid, x.shape)
    np.testing.assert_array_equal(got.numpy(), back)
    np.testing.assert_array_equal(got.numpy(), 2 * x * np.kron(act, np.ones((8, 8)))[..., None])


def _bev(seed=0, clusters=((5, 12, 8, 14), (40, 44, 50, 60))):
    rng = np.random.RandomState(seed)
    bev = np.zeros((2, GRID, GRID, 32), np.float32)
    mask = np.zeros((2, GRID, GRID), bool)
    for i, (y0, y1, x0, x1) in enumerate(clusters):
        mask[i % 2, y0:y1, x0:x1] = True
    mask[1, 20:26, 30:33] = True
    bev[mask] = rng.randn(mask.sum(), 32).astype(np.float32)
    return bev, mask


def _dense_variables(bev, mask):
    shapes = jax.eval_shape(lambda: JDense().init(jax.random.PRNGKey(0), bev, mask, False))
    return _numpy_variables(shapes, seed=11)


def test_tile_backbone_matches_jax_and_the_dense_backbone():
    """The tile backbone (tile 16, 16 tiles: no overflow) on the dense
    backbone's weights, mapped as the JAX test maps them: its eval and train
    outputs, its running statistics and its gradient equal the JAX tile
    module's, and its outputs and statistics equal the port's dense
    backbone's."""
    bev, mask = _bev()
    dv = _dense_variables(bev, mask)
    tv = {"params": map_params(dv["params"]), "batch_stats": map_stats(dv["batch_stats"])}
    jm = JTile(tile=16, max_tiles=16)
    w = np.random.RandomState(2).randn(2, GRID // 8, GRID // 8, 256).astype(np.float32)
    outs = _np(jax.jit(lambda v: [jm.apply(v, bev, mask, train, mutable=["batch_stats"])
                                  for train in (False, True)])(tv))
    tm = load_jax_variables(bts.PillarRes18BackBone8xTileSparse(tile=16, max_tiles=16), tv)
    dm = load_jax_variables(sp.PillarRes18BackBone8x(), dv)
    for train, (jout, upd) in zip((False, True), outs):
        tout = tm.train(train)(T(bev), T(mask))
        dout = dm.train(train)(T(bev), T(mask))
        for k in ("x_conv1", "x_conv2", "x_conv3", "x_conv4", "x_conv5"):
            assert _rel_l2(tout[k].detach().numpy(), jout[k]) <= 1e-5, (train, k)
            assert _rel_l2(tout[k].detach().numpy(), dout[k].detach().numpy()) <= 1e-5, (train, k)
        for n in (1, 2, 3, 4):
            np.testing.assert_array_equal(tout[f"mask{n}"].numpy(), jout[f"mask{n}"])
        stats = tm.tile_stats()
        assert not any(bool(s["overflow"]) for s in stats.values())
        assert [s["tile"] for s in stats.values()] == [16, 16, 16, 8]
    for k, v in state_dict_from_jax(tm, dict(upd)).items():
        np.testing.assert_allclose(tm.state_dict()[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    # the same weights carried across from the port's dense backbone
    for k, v in bts.state_from_dense(tm, dm.state_dict()).items():
        if "running" not in k:
            assert torch.equal(v, tm.state_dict()[k]), k
    # the dense backbone's train forward left the same running statistics
    dense = dm.state_dict()
    for k, v in tm.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), dense[bts.dense_name(k)].numpy(), atol=1e-5,
                                       err_msg=k)
    # the gradient of stages 1-4 equals the dense backbone's
    tm = load_jax_variables(bts.PillarRes18BackBone8xTileSparse(tile=16, max_tiles=16), tv)
    dm = load_jax_variables(sp.PillarRes18BackBone8x(), dv)
    for m in (tm, dm):
        (m.train()(T(bev), T(mask))["x_conv4"] * T(w)).sum().backward()
    dparams = dict(dm.named_parameters())
    got, want = [], []
    for k, p in tm.named_parameters():
        if k.startswith("conv5"):
            continue
        g = dparams[bts.dense_name(k)].grad
        if g.shape != p.shape:  # OIHW -> HWIO, or the HWIO conv2_down -> OIHW
            g = g.permute(2, 3, 1, 0) if k.endswith("_kernel") else g.permute(3, 2, 0, 1)
        got.append(p.grad.numpy().ravel())
        want.append(g.numpy().ravel())
    assert _rel_l2(np.concatenate(got), np.concatenate(want)) <= 1e-4


def test_tile_backbone_overflow_and_registry():
    """At a capacity below the active tiles the flag is up and the dropped
    tiles' cells read zero; both registry names build the tile backbone from
    a config with its ``TILE`` and ``MAX_TILES``."""
    bev, mask = _bev(seed=1)
    dv = _dense_variables(bev, mask)
    tv = {"params": map_params(dv["params"]), "batch_stats": map_stats(dv["batch_stats"])}
    tm = load_jax_variables(bts.PillarRes18BackBone8xTileSparse(tile=16, max_tiles=2), tv)
    out = tm(T(bev), T(mask))
    stats = tm.tile_stats()["stage1"]
    assert bool(stats["overflow"]) and int(stats["active"]) > 2
    assert (out["x_conv1"].abs().sum(-1) > 0).sum() < mask.sum()
    from radardistill_tpu_torch.utils.production import production_cfg

    import os

    full, info = production_cfg(os.path.join(os.path.dirname(__file__), "..", "tools", "cfgs",
                                             "nuscenes_models", "pillarnet_radar.yaml"), grid=64)
    full.MODEL.RADAR_BACKBONE_3D.NAME = "Radar_PillarRes18BackBone8x_TileSparse"
    full.MODEL.RADAR_BACKBONE_3D.MAX_TILES = 40
    model = build_network(full.MODEL, info, device="cpu")
    bk = model.radar_backbone_3d
    assert isinstance(bk, bts.PillarRes18BackBone8xTileSparse)
    assert (bk.stage1.tile, bk.stage1.max_tiles) == (32, 40)
