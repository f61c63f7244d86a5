"""The port's data pipeline against the JAX package's, on the CPU.

Each module of ``radardistill_tpu_torch/data/`` that is a copy of a jax-free
module of ``radardistill_tpu/data/`` (``box_np``, the point feature encoder,
the processor, the augmentor, the GT sampler, the datasets, the loader, the
device-free metric) gets the same seeded numpy inputs as its original and must
give the same outputs: bit-equal arrays, equal dicts, equal floats. The loader
runs both packages' ``build_dataloader`` on ``production_cert_grid128.yaml``
(the model's ``HostPrecompute`` as the batch transform) and compares every
batch of two epochs, with 0 and 2 workers, after ``set_start_iter`` and on
the eval loader's wrapped tail. The one intended difference: the port widens
the uint16 rulebooks of ``hp_as`` to int32 (PyTorch indexes with int32/int64),
so there the values must be equal and the port's dtype int32.
"""

import copy
import pickle
from pathlib import Path

import numpy as np
import pytest

from radardistill_tpu.config import ConfigDict as JConfigDict
from radardistill_tpu.config import cfg_from_yaml_file as j_cfg_from_yaml_file
from radardistill_tpu.data import augmentor as j_augmentor
from radardistill_tpu.data import box_np as j_box_np
from radardistill_tpu.data import dataset as j_dataset
from radardistill_tpu.data import loader as j_loader
from radardistill_tpu.data import point_feature_encoder as j_encoder
from radardistill_tpu.data import processor as j_processor
from radardistill_tpu.data import sampler as j_sampler
from radardistill_tpu.data.nuscenes import eval_bridge as j_bridge
from radardistill_tpu_torch.config import ConfigDict, cfg_from_yaml_file
from radardistill_tpu_torch.data import augmentor, box_np, dataset, loader
from radardistill_tpu_torch.data import point_feature_encoder as encoder
from radardistill_tpu_torch.data import processor, sampler
from radardistill_tpu_torch.data.nuscenes import eval_bridge

REPO = Path(__file__).resolve().parent.parent
GRID128 = REPO / "tools" / "cfgs" / "synthetic" / "production_cert_grid128.yaml"


def assert_same(got, want, path="", widened=False):
    """Equal nesting, keys, dtypes and values (bit for bit); below ``hp_as``
    a uint16 original may come out int32 with equal values."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}", widened or k == "hp_as")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", widened)
    elif isinstance(want, np.ndarray):
        want_dtype = np.dtype(np.int32) if widened and want.dtype == np.uint16 else want.dtype
        assert got.dtype == want_dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, np.random.RandomState):
        g, w = got.get_state(), want.get_state()
        assert np.array_equal(g[1], w[1]) and g[2:] == w[2:], path
    else:
        assert got == want, (path, got, want)


def scene(seed=0, n_boxes=6):
    rng = np.random.RandomState(seed)
    boxes = np.zeros((n_boxes, 9), np.float32)
    boxes[:, :2] = rng.uniform(-15, 15, (n_boxes, 2))
    boxes[:, 3:6] = rng.uniform(1, 4, (n_boxes, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    boxes[:, 7:9] = rng.uniform(-2, 2, (n_boxes, 2))
    return {
        "points": rng.uniform(-20, 20, (500, 5)).astype(np.float32),
        "radar_points": rng.uniform(-20, 20, (80, 6)).astype(np.float32),
        "gt_boxes": boxes, "gt_names": np.array(["car", "bus", "tree"] * (n_boxes // 3)),
        "_rng": np.random.RandomState(42),
    }


# ------------------------------------------------------------------- box_np

def _box_args(name):
    rng = np.random.RandomState(3)
    pts = rng.uniform(-10, 10, (300, 5)).astype(np.float32)
    boxes = scene(1)["gt_boxes"] / 2
    pts[:60, :3] = boxes[np.arange(60) % 6, :3] + rng.uniform(-0.4, 0.4, (60, 3))
    return {
        "rotate_points_along_z": (pts, 0.7),
        "boxes_to_corners_bev": (boxes,),
        "points_in_boxes": (pts[:, :3], boxes),
        "enlarge_box3d": (boxes, (0.5, 0.25, 0.1)),
        "remove_points_in_boxes3d": (pts, boxes),
        "mask_boxes_outside_range": (boxes * 3, [-10, -10, -5, 10, 10, 3], 2),
        "boxes_iou_bev_cpu": (boxes[:, :7], np.roll(boxes[:, :7], 1, axis=0) + 0.3),
    }[name]


@pytest.mark.parametrize("name", ["rotate_points_along_z", "boxes_to_corners_bev",
                                  "points_in_boxes", "enlarge_box3d",
                                  "remove_points_in_boxes3d", "mask_boxes_outside_range",
                                  "boxes_iou_bev_cpu"])
def test_box_np_matches_jax(name):
    args = _box_args(name)
    got, want = getattr(box_np, name)(*args), getattr(j_box_np, name)(*args)
    assert_same(got, want)
    assert np.asarray(want).size > 0 and np.any(want)


# --------------------------------------------------- encoder and processor

def test_point_feature_encoder_matches_jax():
    cfg = {"used_feature_list": ["x", "y", "z", "timestamp"],
           "src_feature_list": ["x", "y", "z", "intensity", "timestamp"],
           "radar_used_feature_list": ["x", "y", "z", "vx", "vy"],
           "radar_src_feature_list": ["x", "y", "z", "rcs", "vx", "vy"]}
    for c in (cfg, {}):
        got, want = encoder.PointFeatureEncoderDistill(c), j_encoder.PointFeatureEncoderDistill(c)
        assert (got.num_point_features, got.radar_num_point_features) == (
            want.num_point_features, want.radar_num_point_features)
        assert_same(got(scene()), want(scene()))


PROCESSOR_STEPS = {
    "mask_points_and_boxes_outside_range": {"REMOVE_OUTSIDE_BOXES": True, "min_num_corners": 2},
    "shuffle_points": {"SHUFFLE_ENABLED": {"train": True, "test": True}},
    "transform_points_to_voxels_placeholder": {"VOXEL_SIZE": [0.5, 0.5, 1.0]},
    "transform_points_to_voxels": {"VOXEL_SIZE": [0.5, 0.5, 1.0], "MAX_POINTS_PER_VOXEL": 3,
                                   "MAX_NUMBER_OF_VOXELS": {"train": 300, "test": 300}},
    "sample_points": {"NUM_POINTS": {"train": 200, "test": 200}},
}


@pytest.mark.parametrize("name", sorted(PROCESSOR_STEPS))
@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_processor_step_matches_jax(name, training):
    cfgs = [{"NAME": name, **PROCESSOR_STEPS[name]}]
    if not name.startswith("transform"):
        cfgs.append({"NAME": "transform_points_to_voxels_placeholder", "VOXEL_SIZE": [0.5, 0.5, 1]})
    pcr = [-16, -16, -4, 16, 16, 4]
    got = processor.DataProcessor(cfgs, pcr, training)
    want = j_processor.DataProcessor(cfgs, pcr, training)
    assert_same(got.grid_size, want.grid_size)
    assert_same(got.voxel_size, want.voxel_size)
    assert_same(got(scene()), want(scene()))


# ---------------------------------------------------------------- augmentor

AUGMENTATIONS = {
    "random_world_flip_distill": {"ALONG_AXIS_LIST": ["x", "y"]},
    "random_world_rotation_distill": {"WORLD_ROT_ANGLE": [-0.785, 0.785]},
    "random_world_scaling_distill": {"WORLD_SCALE_RANGE": [0.9, 1.1]},
    "random_world_translation_distill": {"NOISE_TRANSLATE_STD": [0.5, 0.5, 0.2]},
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(AUGMENTATIONS) + ["all"])
def test_augmentation_matches_jax(name, seed):
    """Each augmentation (and the four in a row, with the heading wrap of
    ``forward``) under the same ``RandomState``."""
    names = sorted(AUGMENTATIONS) if name == "all" else [name]
    cfgs = {"AUG_CONFIG_LIST": [{"NAME": n, **AUGMENTATIONS[n]} for n in names]}
    d = scene()
    d["_rng"] = np.random.RandomState(seed)
    got = augmentor.DataAugmentor(cfgs, ["car"])(copy.deepcopy(d))
    want = j_augmentor.DataAugmentor(cfgs, ["car"])(copy.deepcopy(d))
    assert_same(got, want)


def test_disable_augmentation_matches_jax():
    cfgs = {"AUG_CONFIG_LIST": [{"NAME": n, **c} for n, c in AUGMENTATIONS.items()],
            "DISABLE_AUG_LIST": ["placeholder"]}
    off = {**cfgs, "DISABLE_AUG_LIST": ["random_world_scaling_distill",
                                        "random_world_flip_distill"]}
    got, want = augmentor.DataAugmentor(cfgs, ["car"]), j_augmentor.DataAugmentor(cfgs, ["car"])
    got.disable_augmentation(off)
    want.disable_augmentation(off)
    assert [f.func.__name__ for f in got.data_augmentor_queue] == [
        f.func.__name__ for f in want.data_augmentor_queue] == [
        "random_world_rotation_distill", "random_world_translation_distill"]
    assert_same(got(scene()), want(scene()))


# ------------------------------------------------------------------ sampler

def _gt_database(root: Path):
    """Crops of three classes on disk, their infos pickle and the packed
    (integrated) arrays, as tests/test_data_pipeline.py builds them."""
    import argparse

    from tools.process_tools.create_integrated_database import create_integrated_db_with_infos

    rng = np.random.RandomState(3)
    (root / "crops").mkdir()
    db = {"car": [], "bus": [], "truck": []}
    for i, cls in enumerate(["car", "car", "bus", "car", "truck", "bus", "car"]):
        pts = rng.randn(4 + i, 5).astype(np.float32)
        radar = rng.randn(2 + i % 3, 6).astype(np.float32)
        pts.tofile(root / "crops" / f"c{i}.bin")
        radar.tofile(root / "crops" / f"r{i}.bin")
        box = np.array([i * 4.0 - 12, (-1) ** i * 6.0, 0, 2, 2, 2, 0.3 * i, 0, 0], np.float32)
        db[cls].append({"name": cls, "path": f"crops/c{i}.bin", "radar_path": f"crops/r{i}.bin",
                        "box3d_lidar": box, "num_points_in_gt": 4 + i,
                        "num_radar_points_in_gt": i % 3})
    with open(root / "db.pkl", "wb") as f:
        pickle.dump(db, f)
    create_integrated_db_with_infos(argparse.Namespace(
        src_db_info=str(root / "db.pkl"), new_db_name="gt_global", num_point_features=5,
        num_radar_features=6), root)


@pytest.mark.parametrize("mmap", [False, True], ids=["files", "integrated"])
@pytest.mark.parametrize("distill", [True, False], ids=["distill", "lidar"])
def test_sampler_matches_jax(tmp_path, mmap, distill):
    _gt_database(tmp_path)
    cfg = {"DB_INFO_PATH": ["db.pkl"],
           "PREPARE": {"filter_by_min_points": ["car:5", "bus:1", "truck:1"],
                       "filter_by_min_radar_points": ["bus:1"],
                       "filter_by_difficulty": [-1]},
           "SAMPLE_GROUPS": ["car:2", "bus:2", "truck:1"], "NUM_POINT_FEATURES": 5,
           "REMOVE_EXTRA_WIDTH": [0.5, 0.5, 0.5], "LIMIT_WHOLE_SCENE": False}
    if mmap:
        cfg.update(USE_SHARED_MEMORY=True, DB_DATA_PATH=["gt_global.npy"])
    classes = ["car", "bus", "truck"]
    got = sampler.DataBaseSampler(tmp_path, copy.deepcopy(cfg), classes, distill=distill)
    want = j_sampler.DataBaseSampler(tmp_path, copy.deepcopy(cfg), classes, distill=distill)
    assert_same({k: [i["path"] for i in v] for k, v in got.db_infos.items()},
                {k: [i["path"] for i in v] for k, v in want.db_infos.items()})
    sampled = 0
    for seed in range(3):  # the round-robin pointers move on between calls
        d = scene(seed)
        d["gt_names"] = np.array(["car", "bus", "car", "truck", "car", "bus"])
        d["gt_boxes_mask"] = np.ones(6, bool)
        d["_rng"] = np.random.RandomState(seed)
        out, ref = got(copy.deepcopy(d)), want(copy.deepcopy(d))
        assert_same(out, ref)
        sampled += len(ref["gt_boxes"]) - 6
    assert sampled > 0


# --------------------------------------------------------- datasets, loader

def _cfgs(**data):
    """The grid-128 yaml through each package's config module."""
    cfg, jcfg = ConfigDict(), JConfigDict()
    cfg_from_yaml_file(str(GRID128), cfg)
    j_cfg_from_yaml_file(str(GRID128), jcfg)
    for c in (cfg, jcfg):
        c.DATA_CONFIG.update(data)
    assert cfg == jcfg
    return cfg, jcfg


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_dataset_items_match_jax(training):
    cfg, jcfg = _cfgs()
    got = dataset.SyntheticDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=training)
    want = j_dataset.SyntheticDataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=training)
    assert len(got) == len(want) == 4
    assert_same(got.grid_size, want.grid_size)
    for i in range(len(want)):
        assert_same(got[i], want[i])
    assert_same(got.collate([got[0], got[3]]), want.collate([want[0], want[3]]))


def _batches(ld, epochs=(0, 1), start_iter=None):
    out = []
    for e in epochs:
        ld.set_epoch(e)
        if start_iter is not None:
            ld.set_start_iter(start_iter)
        out.extend(ld)
    return out


@pytest.fixture(scope="module")
def loaders():
    """Both packages' train and eval loaders (5 samples: the eval loader's
    last batch wraps) with the model's HostPrecompute, and the serial batches
    of two epochs of each."""
    cfg, jcfg = _cfgs(NUM_SAMPLES=5)
    built = {}
    for name, (build, c) in {"port": (loader.build_dataloader, cfg),
                             "jax": (j_loader.build_dataloader, jcfg)}.items():
        for training in (True, False):
            built[name, training] = build(c.DATA_CONFIG, c.CLASS_NAMES, 2, training=training,
                                          seed=3, model_cfg=c.MODEL)[1]
    serial = {k: _batches(v) for k, v in built.items()}
    return built, serial


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_loader_batches_match_jax(loaders, training):
    built, serial = loaders
    got, want = serial["port", training], serial["jax", training]
    assert len(want) == (4 if training else 6)
    assert_same(got, want)
    assert {k for k in want[0][0] if k.startswith("hp_")} == {
        "hp_lidar", "hp_masks", "hp_radar", "hp_as"}
    if not training:  # 5 frames at bs2: the last batch wraps frame 0
        assert [h["frame_id"] for _, h in want[:3]] == [
            ["synthetic_0", "synthetic_1"], ["synthetic_2", "synthetic_3"],
            ["synthetic_4", "synthetic_0"]]
    else:  # the epochs shuffle differently
        assert want[0][1]["frame_id"] != want[2][1]["frame_id"]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_loader_workers_and_start_iter_match_jax(loaders, training):
    """Two forked workers give the serial batches; set_start_iter skips
    batches of the next epoch only, with and without workers."""
    built, serial = loaders
    ld = built["port", training]
    ld.workers = 2
    try:
        assert_same(_batches(ld), serial["port", training])
        skipped = _batches(ld, epochs=(1,), start_iter=1)
    finally:
        ld.workers = 0
    per_epoch = len(serial["port", training]) // 2
    assert_same(skipped, serial["jax", training][per_epoch + 1:])
    assert_same(_batches(ld, epochs=(1,)), serial["jax", training][per_epoch:])


def test_unported_datasets_raise(tmp_path):
    """The four nuScenes names no longer raise: each builds its dataset under
    the reference's registry name (here over a tree without infos; the items
    are held against the JAX package in tests/test_torch_nuscenes.py)."""
    from radardistill_tpu_torch.data.nuscenes import dataset as nds

    cfg, _ = _cfgs()
    for name, cls in (("NuScenesDataset_Distill", nds.NuScenesDatasetDistill),
                      ("NuScenesDataset_radar", nds.NuScenesDatasetRadar),
                      ("NuScenesDataset_radar_test", nds.NuScenesDatasetRadarTest),
                      ("NuScenesDataset", nds.NuScenesDataset)):
        ds, ld = loader.build_dataloader(
            {**cfg.DATA_CONFIG, "DATASET": name, "INFO_PATH": {"train": ["none.pkl"]}},
            cfg.CLASS_NAMES, 2, root_path=tmp_path)
        assert type(ds) is cls and len(ds) == 0 and len(ld) == 0


# ------------------------------------------------------------------ metrics

def _detections(seed=0, n=6):
    """Per-sample GT of the synthetic scenes and noisy detections of them."""
    rng = np.random.RandomState(seed)
    jcfg = _cfgs()[1]
    ds = j_dataset.SyntheticDataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=False,
                                    num_samples=n)
    annos = []
    for i in range(n):
        raw = ds.get_item_raw(i)
        keep = rng.rand(len(raw["gt_boxes"])) < 0.7
        boxes = raw["gt_boxes"][keep].copy()
        boxes[:, :3] += rng.normal(0, 0.6, (len(boxes), 3))
        boxes[:, 3:6] *= rng.uniform(0.8, 1.2, (len(boxes), 3))
        names = raw["gt_names"][keep].copy()
        names[rng.rand(len(names)) < 0.1] = "car"
        fp = raw["gt_boxes"][:2].copy()
        fp[:, :2] += 5.0
        annos.append({"pred_boxes": np.concatenate([boxes, fp]).astype(np.float32),
                      "pred_scores": rng.rand(len(boxes) + 2).astype(np.float32),
                      "name": np.concatenate([names, raw["gt_names"][:2]]),
                      "frame_id": f"synthetic_{i}"})
    return ds, annos


def test_detection_metrics_match_jax():
    ds, annos = _detections()
    gts = [ds.get_item_raw(i) for i in range(len(annos))]
    args = ([g["gt_boxes"] for g in gts], [g["gt_names"] for g in gts],
            [a["pred_boxes"] for a in annos], [a["pred_scores"] for a in annos],
            [a["name"] for a in annos], ds.class_names)
    want = j_bridge.detection_metrics(*args)
    assert_same(eval_bridge.detection_metrics(*args), want)
    assert_same(eval_bridge.center_distance_ap(*args), j_bridge.center_distance_ap(*args))
    assert 0 < want["mean_ap"] < 1


def test_synthetic_evaluation_matches_jax():
    _, annos = _detections(1)
    cfg, jcfg = _cfgs()
    got = dataset.SyntheticDataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=False)
    want = j_dataset.SyntheticDataset(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, training=False)
    res, ref = got.evaluation(annos, cfg.CLASS_NAMES), want.evaluation(annos, jcfg.CLASS_NAMES)
    assert_same(res, ref)
    assert "mAP" in ref[1] and ref[1]["mAP"] > 0


def test_update_recall_record_matches_jax():
    from radardistill_tpu.train.eval_utils import update_recall_record as j_update
    from radardistill_tpu_torch.train.eval_utils import update_recall_record

    ds, annos = _detections(2)
    got, want = {}, {}
    for i, a in enumerate(annos):
        gt = ds.get_item_raw(i)["gt_boxes"][:, :7]
        got = update_recall_record(got, a["pred_boxes"][:, :7], gt, (0.1, 0.3, 0.5))
        want = j_update(want, a["pred_boxes"][:, :7], gt, (0.1, 0.3, 0.5))
    got = update_recall_record(got, np.zeros((0, 7)), gt, (0.1, 0.3, 0.5))
    want = j_update(want, np.zeros((0, 7)), gt, (0.1, 0.3, 0.5))
    assert got == want and want["recall_rcnn_0.1"] > 0
