"""The port's own copies of the host-side helpers against the originals in the
JAX package: the same seeded inputs in, equal arrays out.

Covers ``production_cfg`` (deep equality of the loaded yaml and the dataset
info), ``make_scene``, ``collate_batch``, ``pillar_encode`` (plain and packed
order; the port builds its own ``host_ops`` library from its own copy of the
C++ source), ``as_tables``, ``mask_pyramid``, the ``HostPrecompute`` transform
of both shipped configurations, and the packing helpers the teacher's entry
uses (``unpack_bool``, ``packed_addr``, ``densify_packed_direct_batch``,
``space_to_depth``, ``pack_mask``, the packed kernel assembly). Everything
here is integer or pure data movement, so every comparison is bit-equal.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radardistill_tpu.data import collate as jcollate
from radardistill_tpu.data import host_precompute as jhp
from radardistill_tpu.data import synthetic as jsyn
from radardistill_tpu.models import backbone_s2d as js2d
from radardistill_tpu.ops import active_site as jasx
from radardistill_tpu.utils import bitpack as jbitpack
from radardistill_tpu.utils import production as jprod
from radardistill_tpu_torch.data import collate, host_ops, host_precompute as hp, synthetic
from radardistill_tpu_torch.models import backbone_s2d as s2d
from radardistill_tpu_torch.ops import active_site as asx
from radardistill_tpu_torch.utils import bitpack, production

GRID = 128


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, (path, got, want)


def _merged(base, over):
    """``over`` merged into ``base`` the reference's way (dicts recursively,
    everything else replaced)."""
    out = dict(base)
    for k, v in over.items():
        out[k] = _merged(out.get(k) or {}, v) if isinstance(v, dict) else v
    return out


@pytest.mark.parametrize("yaml_name", [production.VAL_YAML, production.TRAIN_YAML])
@pytest.mark.parametrize("grid", [None, GRID])
def test_production_cfg_equals_original(yaml_name, grid):
    """Equal to the JAX package's, with ``DATA_CONFIG``'s nested
    ``_BASE_CONFIG_`` (the nuScenes dataset yaml) expanded as the reference's
    loader expands it: the port's loader does, the JAX package's keeps the
    key unexpanded."""
    import yaml

    cfg, info = production.production_cfg(yaml_name, grid=grid)
    jcfg, jinfo = jprod.production_cfg(yaml_name, grid=grid)
    assert type(cfg).__module__.startswith("radardistill_tpu_torch.")
    jdata = dict(jcfg["DATA_CONFIG"])
    with open(jdata.pop("_BASE_CONFIG_")) as f:
        jdata = _merged(yaml.safe_load(f), jdata)
    assert "_BASE_CONFIG_" not in cfg["DATA_CONFIG"] and cfg["DATA_CONFIG"]["DATASET"]
    assert dict(cfg) == {**dict(jcfg), "DATA_CONFIG": jdata}
    assert info == jinfo


def test_make_scene_and_collate_equal_original():
    kw = dict(num_lidar=3000, num_radar=300, num_boxes=12, pc_range=(-4.8, -4.8, -5.0, 4.8, 4.8, 3.0))
    scenes = [synthetic.make_scene(s, **kw) for s in (0, 1)]
    jscenes = [jsyn.make_scene(s, **kw) for s in (0, 1)]
    _assert_tree_equal(scenes, jscenes)
    caps = {"MAX_LIDAR_POINTS": 2500, "MAX_RADAR_POINTS": 512, "NUM_MAX_OBJS": 50}
    _assert_tree_equal(collate.collate_batch(scenes, caps, seed=3),
                       jcollate.collate_batch(jscenes, caps, seed=3))


@pytest.fixture(scope="module")
def train_batch():
    """A collated two-scene batch of the train configuration at a small grid."""
    full, info = production.production_cfg(production.TRAIN_YAML, grid=GRID)
    scenes = [synthetic.make_scene(s, num_lidar=4000, num_radar=300, num_boxes=10,
                                   pc_range=info["point_cloud_range"]) for s in (0, 1)]
    batch = collate.collate_batch(scenes, {"MAX_LIDAR_POINTS": 4000, "MAX_RADAR_POINTS": 512,
                                           "NUM_MAX_OBJS": 50})
    batch.pop("_host", None)
    return full.MODEL, info, batch


@pytest.mark.parametrize("packed", [False, True])
def test_pillar_encode_equals_original(train_batch, packed):
    _, info, batch = train_batch
    args = (batch["points"], batch["points_mask"], info["point_cloud_range"], info["voxel_size"],
            info["grid_size"], 3000)  # a capacity the pillars overflow
    got = hp.pillar_encode(*args, packed=packed)
    want = jhp.pillar_encode(*args, packed=packed)
    _assert_tree_equal(got, want)
    assert int(got[2]["count"].max()) > 0
    assert str(host_ops._SO).endswith("build/radardistill_tpu_torch/libhost_ops.so")
    assert host_ops._SO.exists()


def test_pillar_encode_packed_rejects_an_odd_grid(train_batch):
    _, info, batch = train_batch
    with pytest.raises(ValueError):
        hp.pillar_encode(batch["points"], batch["points_mask"], info["point_cloud_range"],
                         info["voxel_size"], (GRID + 1, GRID), 3000, packed=True)
    with pytest.raises(ValueError):
        asx.packed_addr(torch.zeros(4, dtype=torch.int32), GRID + 1, GRID)


def test_as_tables_and_mask_pyramid_equal_original(train_batch):
    cfg, info, batch = train_batch
    g = info["grid_size"][0]
    _, _, pre = hp.pillar_encode(batch["radar_points"], batch["radar_points_mask"],
                                 info["point_cloud_range"], info["voxel_size"],
                                 info["grid_size"], 512)
    caps = cfg.RADAR_BACKBONE_3D.MAX_ACTIVE
    _assert_tree_equal(hp.as_tables(pre["uids"], (g, g), caps, 5),
                       jhp.as_tables(pre["uids"], (g, g), caps, 5))
    _, _, lpre = hp.pillar_encode(batch["points"], batch["points_mask"],
                                  info["point_cloud_range"], info["voxel_size"],
                                  info["grid_size"], 4096, packed=True)
    got, want = hp.mask_pyramid(lpre["uids"], (g, g), 3), jhp.mask_pyramid(lpre["uids"], (g, g), 3)
    _assert_tree_equal(got, want)
    assert got[0].dtype == np.uint8 and got[0].shape == (2, g // 2, g // 16)


@pytest.mark.parametrize("yaml_name", [production.VAL_YAML, production.TRAIN_YAML])
def test_host_precompute_equals_original(yaml_name):
    """The whole transform; the port's differs only in widening the uint16
    rulebooks to int32 (same values)."""
    kw = dict(grid=GRID, num_radar=300, num_boxes=10)
    if yaml_name == production.TRAIN_YAML:
        kw["num_lidar"] = 4000
    cfg, info, got = synthetic.make_batch(yaml_name, **kw)
    sz = dict(synthetic.BATCH_SIZES[yaml_name], **{k: v for k, v in kw.items() if k != "grid"})
    scenes = []
    for i in range(sz["batch_size"]):
        scene = jsyn.make_scene(i, num_lidar=sz["num_lidar"] or 100, num_radar=sz["num_radar"],
                                num_boxes=sz["num_boxes"], pc_range=info["point_cloud_range"])
        if sz["num_lidar"] is None:
            del scene["points"]
        scenes.append(scene)
    caps = {"MAX_RADAR_POINTS": sz["max_radar_points"], "NUM_MAX_OBJS": 500}
    if sz["num_lidar"] is not None:
        caps["MAX_LIDAR_POINTS"] = sz["num_lidar"]
    want = jcollate.collate_batch(scenes, caps)
    want.pop("_host", None)
    want = jhp.HostPrecompute(cfg, info["grid_size"], info["voxel_size"],
                              info["point_cloud_range"])(copy.deepcopy(want))
    want["hp_as"] = {k: tuple(a.astype(np.int32) if a.dtype == np.uint16 else a for a in v)
                     if isinstance(v, tuple) else v for k, v in want["hp_as"].items()}
    _assert_tree_equal(got, want)
    if yaml_name == production.TRAIN_YAML:
        assert "ids" not in got["hp_lidar"] and len(got["hp_masks"]) == 3


def test_make_batch_sizes_of_the_two_configurations():
    """The full-size inputs are the ones the JAX package's bench feeds."""
    assert synthetic.BATCH_SIZES[production.TRAIN_YAML] == dict(
        batch_size=2, num_lidar=160_000, num_radar=3000, num_boxes=60, max_radar_points=4096)
    assert synthetic.BATCH_SIZES[production.VAL_YAML] == dict(
        batch_size=1, num_lidar=None, num_radar=3000, num_boxes=40, max_radar_points=8192)


# ------------------------------------------------------ packing helpers


def test_unpack_bool_matches_jax():
    m = np.random.RandomState(0).rand(2, 9, 37) > 0.5
    packed = bitpack.pack_bool_np(m)
    np.testing.assert_array_equal(packed, jbitpack.pack_bool_np(m))
    got = bitpack.unpack_bool(torch.from_numpy(packed), 37)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbitpack.unpack_bool_jnp(jnp.asarray(packed), 37)))
    np.testing.assert_array_equal(got.numpy(), m)


def test_space_to_depth_pack_mask_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 12, 5).astype(np.float32)
    got = s2d.space_to_depth(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(js2d.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(s2d.depth_to_space(got, 5).numpy(), x)
    mask = rng.rand(2, 8, 12) > 0.5
    mp = s2d.pack_mask(torch.from_numpy(mask))
    np.testing.assert_array_equal(mp.numpy(), np.asarray(js2d.pack_mask(jnp.asarray(mask))))
    np.testing.assert_array_equal(
        s2d._phase_mask_flat(mp, 3).numpy(), np.asarray(js2d._phase_mask_flat(jnp.asarray(mp.numpy()), 3)))


@pytest.mark.parametrize("name,cin,cout", [("pack_subm_kernel", 6, 10), ("pack_down_kernel", 6, 10),
                                           ("pack_subm_kernel", 32, 32), ("pack_down_kernel", 32, 64)])
def test_packed_kernels_match_jax(name, cin, cout):
    k = np.random.RandomState(2).randn(3, 3, cin, cout).astype(np.float32)
    got = getattr(s2d, name)(torch.from_numpy(k), cin, cout)
    want = np.asarray(getattr(js2d, name)(jnp.asarray(k), cin, cout))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_packed_addr_and_densify_match_jax(train_batch, dtype):
    _, info, batch = train_batch
    g = info["grid_size"][0]
    _, _, pre = hp.pillar_encode(batch["points"], batch["points_mask"],
                                 info["point_cloud_range"], info["voxel_size"],
                                 info["grid_size"], 4096, packed=True)
    uids = pre["uids"]
    addr = asx.packed_addr(torch.from_numpy(uids), g, g)
    np.testing.assert_array_equal(addr.numpy(), np.asarray(jasx.packed_addr(jnp.asarray(uids), g, g)))
    assert (np.diff(addr.numpy(), axis=1) >= 0).all()  # packed order: monotone rows
    rng = np.random.RandomState(3)
    table = (rng.randn(2, 4096, 32) * 20).astype(dtype) * (uids < g * g)[..., None].astype(dtype)
    dense, mask_p = asx.densify_packed_direct_batch(torch.from_numpy(table), torch.from_numpy(uids), (g, g))
    jdense, jmask_p = jasx.densify_packed_direct_batch(jnp.asarray(table), jnp.asarray(uids), (g, g))
    assert dense.dtype == torch.from_numpy(table).dtype and mask_p.dtype == torch.bool
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))
    np.testing.assert_array_equal(mask_p.numpy(), np.asarray(jmask_p))
    assert mask_p.any()
