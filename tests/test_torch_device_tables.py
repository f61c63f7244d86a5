"""The port's device-built table route against the JAX package, CPU.

A batch without ``hp_radar`` / ``hp_as`` / ``hp_lidar`` / ``hp_masks`` makes
both packages sort the points, compact the pillar ids and build every tap
table themselves. Inputs come from a numpy seed.

- The integer functions (``ops/voxelize.py``, ``ops/active_site.py``) are held
  bit-equal to their JAX counterparts, on a batch with a crowded sample, a
  sparse one and an empty one, and under a capacity overflow.
- The VFE without ``pre``: ``uids`` / ``count`` equal, table rel-L2 <= 1e-5
  (the cluster mean is a float32 ``index_add_`` here and two segmented scans
  there: the same sums in another order, about 1e-6 m).
- The port's device-built tables are bit-equal to its own host tables.
- The whole val model at grid 128 with no ``hp_*`` keys, ``DENSE_FROM`` 2-5,
  with the JAX variables bridged: ``radar_preds`` rel-L2 <= 1e-4 (float32
  summation order over ~40 layers), detections as ``tests/test_torch_slice.py``
  compares them.
- One train step of the distillation yaml through the device route, teacher
  ``INT8: false``: the loss against the JAX package's loss of the same
  forward, rtol 1e-4.

The JAX variables of the whole models are not drawn by ``model.init`` (its
compile costs more than the tests): their shapes come from ``jax.eval_shape``
of it, the kernels from a numpy seed at flax's default scale (1 / sqrt(fan
in)), and every BN statistic, scale and bias from ``_perturb``.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.models import build_network as jax_build_network
from radardistill_tpu.models import compute_training_loss as jax_training_loss
from radardistill_tpu.models.vfe import DynamicPillarVFESparse as JaxVFE
from radardistill_tpu.ops import active_site as jasx
from radardistill_tpu.ops import voxelize as jvox
from radardistill_tpu_torch.convert import load_jax_variables
from radardistill_tpu_torch.data import collate, synthetic
from radardistill_tpu_torch.data.host_precompute import HostPrecompute
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.models.backbone_as import PillarRes18BackBone8xAS
from radardistill_tpu_torch.models.detector import batch_to_torch
from radardistill_tpu_torch.models.layers import init_random_
from radardistill_tpu_torch.models.vfe import DynamicPillarVFESparse
from radardistill_tpu_torch.ops import active_site as asx
from radardistill_tpu_torch.ops import voxelize as vox
from radardistill_tpu_torch.train.optim import build_optimizer
from radardistill_tpu_torch.train.train_step import make_train_step
from radardistill_tpu_torch.utils.production import TRAIN_YAML, VAL_YAML, production_cfg
from tests.test_torch_slice import _perturb, _rel_l2, assert_same_detections

# Six xdist workers share the machine's cores: one intra-op thread per worker
# keeps torch's thread pools from oversubscribing them (the suite is bound by
# its total CPU time). The tolerances here hold for any thread count.
torch.set_num_threads(1)

PC_RANGE = (-8.0, -6.0, -3.0, 8.0, 6.0, 3.0)
VOXEL = (0.25, 0.25, 6.0)
GRID_XY = (64, 48)  # (nx, ny)
H, W = 48, 64
PREDS = ("center", "center_z", "dim", "rot", "vel", "iou", "hm")


def _points(n=600, seed=0):
    """(3, n, 5) points: a crowded sample, a sparse one with points outside the
    range, an empty one; and the mask of real points."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1.0, 1.0, (3, n, 5)).astype(np.float32)
    pts[0, :, :2] *= (3.0, 2.5)      # crowded: many points per pillar
    pts[1, :, :2] *= (9.0, 7.0)      # spread beyond the range
    pts[2, :, :2] *= (7.0, 5.0)
    mask = np.ones((3, n), bool)
    mask[1, 400:] = False
    mask[2] = False                  # an empty sample
    return pts, mask


def _ids(pts, mask):
    coords, in_range = jvox.compute_pillar_coords(jnp.asarray(pts[..., :2]), PC_RANGE, VOXEL,
                                                  GRID_XY)
    return np.array(jvox.pillar_ids(coords, jnp.asarray(mask) & in_range, GRID_XY))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_pillar_coords_and_ids_match_jax():
    pts, mask = _points()
    jc, jr = jvox.compute_pillar_coords(jnp.asarray(pts[..., :2]), PC_RANGE, VOXEL, GRID_XY)
    tc, tr = vox.compute_pillar_coords(torch.from_numpy(pts[..., :2]), PC_RANGE, VOXEL, GRID_XY)
    _eq(tc, jc)
    _eq(tr, jr)
    assert 0 < tr.sum() < tr.numel()
    valid = torch.from_numpy(mask) & tr
    _eq(vox.pillar_ids(tc, valid, GRID_XY), jvox.pillar_ids(jc, jnp.asarray(mask) & jr, GRID_XY))


def test_packed_key_matches_jax():
    ids = _ids(*_points())
    got = vox.packed_key(torch.from_numpy(ids), GRID_XY)
    _eq(got, jvox.packed_key(jnp.asarray(ids), GRID_XY))
    assert (got[ids == H * W] == H * W).all() and (got != torch.from_numpy(ids)).any()


@pytest.mark.parametrize("grid", [(63, 48), (64, 47)], ids=["odd-nx", "odd-ny"])
def test_packed_key_rejects_an_odd_grid(grid):
    with pytest.raises(ValueError, match="even grid"):
        vox.packed_key(torch.zeros((1, 4), dtype=torch.int32), grid)


@pytest.mark.parametrize("cap", [512, 40], ids=["fits", "overflow"])
@pytest.mark.parametrize("fn", ["compact_unique", "compact_unique_sorted"])
def test_compact_unique_matches_jax(fn, cap):
    ids = _ids(*_points())
    if fn == "compact_unique_sorted":
        ids = np.sort(ids, axis=1)
    sent = H * W
    want = jax.vmap(lambda i: getattr(jasx, fn)(i, cap, sent))(jnp.asarray(ids))
    got = getattr(asx, fn)(torch.from_numpy(ids), cap, sent)
    for g, w in zip(got, want):
        _eq(g, w)
    count = got[2].numpy()
    assert count[2] == 0 and (got[0][2] == sent).all()  # the empty sample
    assert (count[0] > cap) == (cap == 40)               # the overflow case overflows


def _active_sets(cap1=512):
    ids = np.sort(_ids(*_points()), axis=1)
    uids, _, _ = asx.compact_unique_sorted(torch.from_numpy(ids), cap1, H * W)
    return uids


@pytest.mark.parametrize("cap_out", [512, 96], ids=["fits", "overflow"])
def test_downsample_active_matches_jax(cap_out):
    uids = _active_sets()
    want = jax.vmap(lambda u: jasx.downsample_active(u, (H, W), cap_out))(jnp.asarray(uids.numpy()))
    got = asx.downsample_active(uids, (H, W), cap_out)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert (got[1].numpy()[0] > cap_out) == (cap_out == 96) and got[1][2] == 0


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cap_out", [512, 96], ids=["fits", "overflow"])
def test_tap_tables_match_jax(stride, cap_out):
    """``conv_neighbor_table_b`` and ``invert_taps_b``, submanifold and
    strided, also from an output set that a capacity cut."""
    cap_in = 512
    uids = _active_sets(cap_in)
    if stride == 2:
        out_uids, _ = asx.downsample_active(uids, (H, W), cap_out)
    else:
        out_uids, cap_out = uids, cap_in
    out_w = W // stride
    grid = asx.site_index_grid(uids, H * W, cap_in)
    nb, msk = asx.conv_neighbor_table_b(out_uids, grid, (H, W), out_w, stride, cap_in)
    inv, imsk = asx.invert_taps_b(nb, msk, cap_in)

    ju, jo = jnp.asarray(uids.numpy()), jnp.asarray(out_uids.numpy())
    jgrid = jax.vmap(lambda u: jasx.site_index_grid(u, H * W, cap_in))(ju)
    _eq(grid, jgrid)
    jnb, jmsk = jasx.conv_neighbor_table_b(jo, jgrid, (H, W), out_w, stride, cap_in)
    jinv, jimsk = jasx.invert_taps_b(jnb, jmsk, cap_in)
    for g, w in ((nb, jnb), (msk, jmsk), (inv, jinv), (imsk, jimsk)):
        _eq(g, w)
    assert tuple(nb.shape) == (3, 9, cap_out) and tuple(inv.shape) == (3, 9, cap_in)
    assert msk[0].any() and imsk[0].any() and not msk[2].any()


# ------------------------------------------------------------------ the VFE


@pytest.mark.parametrize("cap", [512, 60], ids=["fits", "overflow"])
@pytest.mark.parametrize("packed", [False, True], ids=["linear", "packed"])
def test_vfe_device_route_matches_jax(packed, cap):
    pts, mask = _points()
    kw = dict(num_filters=(32,), voxel_size=VOXEL, point_cloud_range=PC_RANGE, grid_size=GRID_XY)
    jm = JaxVFE(capacity=cap, packed_order=packed, **kw)
    jp, jmask = jnp.asarray(pts), jnp.asarray(mask)
    variables = _perturb(jax.tree.map(np.asarray, dict(jax.jit(
        lambda k: jm.init(k, jp, jmask, False))(jax.random.PRNGKey(0)))))
    jtable, juids, jcount = jax.jit(lambda v: jm.apply(v, jp, jmask, False))(variables)
    tm = load_jax_variables(DynamicPillarVFESparse(num_point_features=5, capacity=cap,
                                                   packed_order=packed, **kw).eval(), variables)
    with torch.no_grad():
        table, uids, count = tm(torch.from_numpy(pts), torch.from_numpy(mask))
    _eq(uids, juids)
    _eq(count, jcount)
    assert (count.numpy()[0] > cap) == (cap == 60)
    assert _rel_l2(table.numpy(), np.asarray(jtable)) <= 1e-5
    assert not table[2].any()  # the empty sample's table is zero


# ------------------------------------- device tables against the host's own


def _collated(yaml_name, grid, n_lidar, n_radar, slots, seeds=(0, 1)):
    full, info = production_cfg(yaml_name, grid=grid)
    scenes = [synthetic.make_scene(s, num_lidar=n_lidar, num_radar=n_radar, num_boxes=10,
                                   pc_range=info["point_cloud_range"]) for s in seeds]
    caps = {"MAX_RADAR_POINTS": slots, "NUM_MAX_OBJS": 50}
    if yaml_name == VAL_YAML:
        for s in scenes:
            del s["points"]
    else:
        caps["MAX_LIDAR_POINTS"] = n_lidar
    batch = collate.collate_batch(scenes, caps)
    batch.pop("_host", None)
    return full, info, batch


def _numpy_variables(jmodel, jbatch, seed=0):
    """A variable tree of ``jmodel`` without compiling its ``init``."""
    shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, False), jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict({k: shapes[k] for k in ("params", "batch_stats")})
    for k, v in flat.items():
        if k[-1] in ("kernel", "down_weight"):
            flat[k] = (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(
                np.float32)
        else:
            flat[k] = np.ones(v.shape, np.float32)
    return _perturb(flax.traverse_util.unflatten_dict(flat))


@pytest.fixture(scope="module")
def train_inputs():
    full, info, batch = _collated(TRAIN_YAML, 128, 4000, 300, 512)
    full.MODEL.BACKBONE_3D.INT8 = False
    return full, info, batch


@pytest.mark.parametrize("dense_from", [3, 5])
def test_device_tables_equal_host_tables(train_inputs, dense_from):
    """The twin of the JAX package's host-vs-device table tests: the radar
    points of the train batch through ``HostPrecompute`` and through the
    device functions of the port."""
    full, info, batch = train_inputs
    cfg = copy.deepcopy(full.MODEL)
    cfg.RADAR_BACKBONE_3D.DENSE_FROM = dense_from
    geo = (info["grid_size"], info["voxel_size"], info["point_cloud_range"])
    host = batch_to_torch(HostPrecompute(cfg, *geo)(copy.deepcopy(batch)), "cpu")
    raw = batch_to_torch(copy.deepcopy(batch), "cpu")
    model = init_random_(build_network(cfg, info, device="cpu"),
                         torch.Generator().manual_seed(0)).eval()

    with torch.no_grad():
        h_tab, h_uids, h_cnt = model.radar_vfe(host["radar_points"], host["radar_points_mask"],
                                               host["hp_radar"])
        d_tab, d_uids, d_cnt = model.radar_vfe(raw["radar_points"], raw["radar_points_mask"])
    _eq(d_uids, h_uids)
    _eq(d_cnt, h_cnt)
    assert _rel_l2(d_tab.numpy(), h_tab.numpy()) <= 1e-5

    bk = model.radar_backbone_3d
    with torch.no_grad():
        built = bk.build_tables(d_uids)
        out_d = bk(d_tab, d_uids)
    assert set(built) == set(host["hp_as"]) and len(built) == 2 + 3 * (dense_from - 2)
    for name, want in host["hp_as"].items():
        for g, w in zip(built[name], want) if isinstance(want, tuple) else [(built[name], want)]:
            _eq(g, w)
    _, pre = model.radar_vfe.sort_and_compact(raw["radar_points"], raw["radar_points_mask"])
    for k in ("slot", "uids", "count"):
        _eq(pre[k], host["hp_radar"][k])
    with torch.no_grad():
        out_h = bk(d_tab, d_uids, host["hp_as"])
    for k in ("x_conv4", "x_conv5", "as_overflow"):
        _eq(out_d[k], out_h[k])

    # the teacher's table: packed order, from the raw lidar points
    with torch.no_grad():
        ht = model.vfe(host["points"], host["points_mask"], host["hp_lidar"])
        dt = model.vfe(raw["points"], raw["points_mask"])
    _eq(dt[1], ht[1])
    _eq(dt[2], ht[2])
    assert _rel_l2(dt[0].numpy(), ht[0].numpy()) <= 1e-5


def test_densify_all_adds_the_table_stages():
    uids = _active_sets()
    bk = init_random_(PillarRes18BackBone8xAS((H, W), caps=(512, 512, 512, 512), dense_from=3,
                                              densify_all=True),
                      torch.Generator().manual_seed(0)).eval()
    feats = torch.randn(3, 512, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = bk(feats, uids)
    assert tuple(out["x_conv1"].shape) == (3, H, W, 32)
    assert tuple(out["x_conv2"].shape) == (3, H // 2, W // 2, 64)
    assert tuple(out["x_conv3"].shape) == (3, H // 4, W // 4, 128)  # masked-dense stage
    assert out["mask1"].dtype == torch.bool and not out["mask1"][2].any()
    with pytest.raises(ValueError, match="dense_from"):
        PillarRes18BackBone8xAS((H, W), dense_from=6)


# --------------------------------------------------------- the slice as a whole


@pytest.fixture(scope="module")
def val_inputs():
    full, info, batch = _collated(VAL_YAML, 128, 100, 600, 1024, seeds=(0,))
    cfg = full.MODEL
    jbatch = jax.tree.map(jnp.asarray, copy.deepcopy(batch))
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    return cfg, info, batch, jbatch, _numpy_variables(jmodel, jbatch)


@pytest.fixture(scope="module", params=[2, 3, 4, 5])
def val_run(request, val_inputs):
    cfg, info, batch, jbatch, variables = val_inputs
    cfg = copy.deepcopy(cfg)
    cfg.RADAR_BACKBONE_3D.DENSE_FROM = request.param
    assert not any(k.startswith("hp_") for k in batch)
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    if request.param == 3:
        # the variables were shaped by the DENSE_FROM 5 model: the parameter tree
        # does not depend on DENSE_FROM, table and masked-dense stages share
        # checkpoints, and the bridge loads either into the port
        shapes = jax.eval_shape(lambda k, b: jmodel.init(k, b, False), jax.random.PRNGKey(0),
                                jbatch)
        assert (jax.tree.map(lambda x: x.shape, {k: shapes[k] for k in ("params", "batch_stats")})
                == jax.tree.map(lambda x: x.shape, variables))
    jout = jax.tree.map(np.asarray, jax.jit(lambda v, b: jmodel.apply(v, b, False))(variables,
                                                                                   jbatch))
    model = load_jax_variables(build_network(cfg, info, device="cpu"), variables)
    with torch.no_grad():
        tout = model(batch_to_torch(copy.deepcopy(batch), "cpu"))
    return request.param, model, jout, tout


@pytest.mark.parametrize("key", PREDS)
def test_device_route_preds_match_jax(val_run, key):
    _, _, jout, tout = val_run
    got, want = tout["radar_preds"][key].numpy(), jout["radar_preds"][key]
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= 1e-4


def test_device_route_features_and_boxes_match_jax(val_run):
    dense_from, model, jout, tout = val_run
    assert model.radar_backbone_3d.dense_from == dense_from
    for k in ("radar_x_conv4", "radar_spatial_features_2d"):
        assert _rel_l2(tout[k].numpy(), jout[k]) <= 1e-4, k
    assert int(tout["as_overflow"]) == int(jout["as_overflow"]) == 0
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    assert got["valid"].sum() > 0
    assert_same_detections(got, jout["final_box_dicts"], tol=1e-4)


def test_train_step_through_the_device_route_matches_jax(train_inputs):
    full, info, batch = train_inputs
    cfg = full.MODEL
    geo = (info["class_names"], info["voxel_size"], info["point_cloud_range"])
    jbatch = jax.tree.map(jnp.asarray, copy.deepcopy(batch))
    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    variables = _numpy_variables(jmodel, jbatch)

    @jax.jit
    def loss_of(v, b):
        out, _ = jmodel.apply(v, b, True, mutable=["batch_stats", "diagnostics"])
        return jax_training_loss(cfg, out, *geo)[0], out["as_overflow"]

    jloss, joverflow = (float(x) for x in loss_of(variables, jbatch))

    model = load_jax_variables(build_network(cfg, info, device="cpu"), variables)
    opt, _ = build_optimizer(full.OPTIMIZATION, model, 1000, model.frozen)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    metrics = make_train_step(model, opt, cfg, *geo)(batch_to_torch(copy.deepcopy(batch), "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=1e-4)
    assert int(metrics["as_overflow"]) == int(joverflow) == 0
    after = dict(model.named_parameters())
    assert before and all(not torch.equal(after[n], p) for n, p in before.items())
