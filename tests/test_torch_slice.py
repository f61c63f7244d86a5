"""The port's radar-only serving slice against the JAX package, float32, CPU.

One seeded synthetic scene at ``production_cfg(VAL_YAML, grid=256)`` goes
through ``HostPrecompute`` of each package. The JAX variables come from
``model.init``, with every BN statistic and scale, every bias, GRN gamma/beta
and the DCN ``down_bias`` overwritten by seeded numpy values, and are bridged into
the port (``convert.load_jax_variables``). At grid 256 no CMA site passes the
DCN shape gate, so both sides run unclamped.

Tolerances: features and predictions rel-L2 <= 1e-4 (float32 summation order
over ~40 layers; measured ~1e-6). Top-k and NMS are discontinuous: a pair of
candidates whose scores agree to a few ulps may come out in either order, so
detections are compared entry by entry, and an entry that moved may only have
swapped with one of (almost) equal score.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.data.collate import collate_batch
from radardistill_tpu.data.host_precompute import HostPrecompute as JaxHostPrecompute
from radardistill_tpu.data.synthetic import make_scene
from radardistill_tpu.models import build_network as jax_build_network
from radardistill_tpu.utils.production import VAL_YAML, production_cfg
from radardistill_tpu_torch.convert import load_jax_variables
from radardistill_tpu_torch.data.host_precompute import HostPrecompute
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.models.center_head import decode_and_nms
from radardistill_tpu_torch.models.detector import batch_to_torch

# Six xdist workers share the machine's cores: one intra-op thread per worker
# keeps torch's thread pools from oversubscribing them (the suite is bound by
# its total CPU time). The tolerances here hold for any thread count.
torch.set_num_threads(1)

FEATURES = ("radar_x_conv4", "radar_spatial_features_8x_2", "radar_spatial_features_8x_1",
            "radar_spatial_features_2d", "radar_spatial_features_2d_8x")
PREDS = ("center", "center_z", "dim", "rot", "vel", "iou", "hm")


def _perturb(variables, seed=1):
    """Seeded BN statistics and scales, every bias, GRN gamma/beta and
    down_bias (model.init leaves them at 0/1, where a layout slip could hide)."""
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(variables)
    for k, v in flat.items():
        coll, leaf = k[0], k[-1]
        if coll == "batch_stats":
            flat[k] = (rng.uniform(-0.1, 0.1, v.shape) if leaf == "mean"
                       else rng.uniform(0.75, 1.25, v.shape)).astype(np.float32)
        elif leaf in ("gamma", "beta", "down_bias", "bias"):
            flat[k] = rng.uniform(-0.1, 0.1, v.shape).astype(np.float32)
        elif leaf == "scale":
            flat[k] = rng.uniform(0.75, 1.25, v.shape).astype(np.float32)
    return flax.traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def slice_run():
    full, info = production_cfg(VAL_YAML, grid=256)
    cfg = full.MODEL
    scene = make_scene(0, num_lidar=100, num_radar=3000, num_boxes=40,
                       pc_range=info["point_cloud_range"])
    del scene["points"]
    batch = collate_batch([scene], {"MAX_RADAR_POINTS": 8192, "NUM_MAX_OBJS": 500})
    batch.pop("_host", None)
    geo = (info["grid_size"], info["voxel_size"], info["point_cloud_range"])
    jbatch = jax.tree.map(jnp.asarray, JaxHostPrecompute(cfg, *geo)(copy.deepcopy(batch)))
    tbatch = batch_to_torch(HostPrecompute(cfg, *geo)(copy.deepcopy(batch)), "cpu")

    jmodel = jax_build_network(cfg, info, compute_dtype=jnp.float32)
    variables = jax.jit(lambda k, b: jmodel.init(k, b, False))(jax.random.PRNGKey(0), jbatch)
    variables = _perturb(jax.tree.map(np.asarray, {k: v for k, v in variables.items()
                                                   if k in ("params", "batch_stats")}))
    jout = jax.tree.map(np.asarray, jax.jit(lambda v, b: jmodel.apply(v, b, False))(variables, jbatch))

    model = load_jax_variables(build_network(cfg, info, device="cpu"), variables)
    tout = model(tbatch)
    return cfg, info, model, jout, tout


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def assert_same_detections(got, want, tol):
    """Equal validity pattern; entry i of ``got`` equals entry i of ``want``
    (label exactly, box and score within ``tol``) or, where two candidates
    scored within ``tol`` traded places, another unused entry of ``want``
    with that score."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for b in range(want["valid"].shape[0]):
        idx = np.flatnonzero(want["valid"][b])
        row = lambda d: np.concatenate(  # noqa: E731
            [d["boxes"][b, idx], d["scores"][b, idx, None]], axis=1).astype(np.float64)
        g, w = row(got), row(want)
        gl, wl = got["labels"][b, idx], want["labels"][b, idx]
        used = np.zeros(len(idx), bool)
        for i in range(len(idx)):
            ok = (~used & (wl == gl[i]) & (np.abs(w - g[i]).max(axis=1) <= tol)
                  & (np.abs(w[:, -1] - w[i, -1]) <= tol))
            j = i if ok[i] else (np.flatnonzero(ok)[0] if ok.any() else -1)
            assert j >= 0, f"sample {b}: detection {idx[i]} {g[i]} label {gl[i]} has no match"
            used[j] = True


@pytest.mark.parametrize("key", FEATURES)
def test_slice_features_match_jax(slice_run, key):
    *_, jout, tout = slice_run
    assert tuple(tout[key].shape) == jout[key].shape
    assert _rel_l2(tout[key].numpy(), jout[key]) <= 1e-4


@pytest.mark.parametrize("key", PREDS)
def test_slice_preds_match_jax(slice_run, key):
    *_, jout, tout = slice_run
    got, want = tout["radar_preds"][key].numpy(), jout["radar_preds"][key]
    assert got.shape == want.shape
    assert _rel_l2(got, want) <= 1e-4


def test_slice_overflow_matches_jax(slice_run):
    *_, jout, tout = slice_run
    assert int(tout["as_overflow"]) == int(jout["as_overflow"]) == 0


def test_slice_final_boxes_match_jax(slice_run):
    *_, jout, tout = slice_run
    got = {k: v.numpy() for k, v in tout["final_box_dicts"].items()}
    assert got["boxes"].shape == jout["final_box_dicts"]["boxes"].shape
    assert got["valid"].sum() > 0
    assert_same_detections(got, jout["final_box_dicts"], tol=1e-4)


def test_decode_on_jax_preds_matches_jax(slice_run):
    """The JAX radar_preds through the port's decode_and_nms: top-k and NMS
    isolated from upstream float noise."""
    cfg, info, model, jout, _ = slice_run
    head = cfg.RADAR_DENSE_HEAD
    pp = head.POST_PROCESSING
    preds = {k: torch.tensor(v) for k, v in jout["radar_preds"].items()}
    hw = jout["radar_spatial_features_2d"].shape[1:3]
    got = decode_and_nms(
        preds, model.head_spec, hw, head.TARGET_ASSIGNER_CONFIG.FEATURE_MAP_STRIDE,
        info["voxel_size"], info["point_cloud_range"], pp.POST_CENTER_LIMIT_RANGE,
        k_per_head=pp.MAX_OBJ_PER_SAMPLE, score_thresh=pp.SCORE_THRESH,
        rectifier=head.RECTIFIER, nms_thresh=pp.NMS_CONFIG.NMS_THRESH,
        nms_pre=pp.NMS_CONFIG.NMS_PRE_MAXSIZE, nms_post=pp.NMS_CONFIG.NMS_POST_MAXSIZE)
    got = {k: v.numpy() for k, v in got.items()}
    want = jout["final_box_dicts"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(np.sort(got["labels"], axis=1), np.sort(want["labels"], axis=1))
    assert_same_detections(got, want, tol=1e-5)


def test_bridge_maps_every_variable(slice_run):
    """Every port parameter and buffer came from a JAX leaf (strict load),
    and the kernel layouts are the documented ones."""
    _, _, model, _, _ = slice_run
    sd = model.state_dict()
    assert tuple(sd["radar_cma.encoder_1_0.dwconv.conv.weight"].shape) == (256, 1, 7, 7)
    assert tuple(sd["radar_cma.decoder_1.deconv.weight"].shape) == (256, 256, 4, 4)
    assert tuple(sd["radar_cma.encoder_1_0.pwconv1.weight"].shape) == (1024, 256)
    assert tuple(sd["radar_cma.encoder_1_0.grn.gamma"].shape) == (1, 1, 1, 1024)
    assert tuple(sd["radar_dense_head.hm.conv_out.weight"].shape) == (12, 64, 3, 3)
    assert tuple(sd["radar_vfe.pfn_0.norm.running_var"].shape) == (32,)
