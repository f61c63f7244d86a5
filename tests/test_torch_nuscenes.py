"""The port's nuScenes data (``radardistill_tpu_torch/data/nuscenes/``) against
the JAX package's, on the CPU without the devkit.

- pcd: the files ``tests/test_pcd.py::write_pcd`` writes read bit-equal.
- datasets: the fixture tree of ``tests/test_nuscenes_dataset.py`` (built again
  here, one tree a test): ``get_item_raw`` and ``__getitem__`` of the four
  dataset classes bit-equal with augmentation off, and under the same numpy
  seed with the shipped augmentations on (GT sampling from a database that
  ``create_groundtruth_database`` writes); both packages' loaders over the tree.
- info_gen: ``fill_trainval_infos`` and ``create_nuscenes_infos`` against a
  record store, with ``tests/nuscenes_stub.py`` installed in ``sys.modules``
  and the calls it lacks added here; ``create_groundtruth_database`` on the
  fixture: equal dbinfos and crops.
- eval_bridge: under the stubs, ``_official_eval`` writes an equal
  ``results_nusc.json`` and returns equal metrics, and the ``v1.0-test`` split
  stops after the submission; ``_fallback_eval``, ``format_nuscene_results``
  and each dataset's ``evaluation`` give equal strings and dicts.
"""

import copy
import filecmp
import json
import pickle
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from radardistill_tpu.config import ConfigDict as JConfigDict
from radardistill_tpu.data import loader as jloader
from radardistill_tpu.data.nuscenes import dataset as jds
from radardistill_tpu.data.nuscenes import eval_bridge as jeb
from radardistill_tpu.data.nuscenes import info_gen as jig
from radardistill_tpu.data.nuscenes import pcd as jpcd
from radardistill_tpu_torch.config import ConfigDict
from radardistill_tpu_torch.data import loader as tloader
from radardistill_tpu_torch.data.nuscenes import dataset as tds
from radardistill_tpu_torch.data.nuscenes import eval_bridge as teb
from radardistill_tpu_torch.data.nuscenes import info_gen as tig
from radardistill_tpu_torch.data.nuscenes import pcd as tpcd
from tests.test_nuscenes_dataset import build_fixture
from tests.test_pcd import write_pcd

CLASSES = ["car", "truck"]
NAMES = ("NuScenesDataset_Distill", "NuScenesDataset_radar", "NuScenesDataset_radar_test",
         "NuScenesDataset")
INFO_TRAIN = "nuscenes_infos_6radar_2sweeps_train.pkl"


def assert_same(a, b, path="item"):
    """Equal structure, dtypes and values, bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, np.random.RandomState):
        assert isinstance(b, np.random.RandomState), path
    else:
        assert a == b, path


def _tree(root):
    """The fixture tree, with its train infos also under the name that
    ``create_groundtruth_database`` reads (2 sweeps)."""
    build_fixture(root)
    shutil.copy(root / "infos_train.pkl", root / INFO_TRAIN)
    shutil.copy(root / "infos_val.pkl", root / INFO_TRAIN.replace("train", "val"))
    return root


def _cfg(root, cls, aug):
    cfg = dict(
        DATASET="NuScenesDataset_Distill", DATA_PATH=str(root), VERSION="v1.0-mini",
        MAX_SWEEPS=2, PRED_VELOCITY=True, SET_NAN_VELOCITY_TO_ZEROS=True,
        INFO_PATH={"train": ["infos_train.pkl"], "test": ["infos_val.pkl"]},
        POINT_CLOUD_RANGE=[-54.0, -54.0, -5.0, 54.0, 54.0, 3.0], POINT_FEATURE_ENCODING={},
        CAPACITIES={"MAX_LIDAR_POINTS": 128, "MAX_RADAR_POINTS": 32, "NUM_MAX_OBJS": 16},
        DATA_PROCESSOR=[
            {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
            {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": True}},
            {"NAME": "transform_points_to_voxels_placeholder",
             "VOXEL_SIZE": [0.075, 0.075, 0.2]}])
    if aug:
        cfg["DATA_AUGMENTOR"] = {"DISABLE_AUG_LIST": ["placeholder"], "AUG_CONFIG_LIST": [
            {"NAME": "gt_sampling_distill",
             "DB_INFO_PATH": ["nuscenes_dbinfos_2sweeps_with_radar_withvelo.pkl"],
             "PREPARE": {"filter_by_min_points": ["car:1", "truck:1"]},
             "SAMPLE_GROUPS": ["car:4", "truck:4"], "NUM_POINT_FEATURES": 5,
             "DATABASE_WITH_FAKELIDAR": False, "REMOVE_EXTRA_WIDTH": [0.0, 0.0, 0.0],
             "LIMIT_WHOLE_SCENE": True},
            {"NAME": "random_world_flip_distill", "ALONG_AXIS_LIST": ["x", "y"]},
            {"NAME": "random_world_rotation_distill", "WORLD_ROT_ANGLE": [-0.78, 0.78]},
            {"NAME": "random_world_scaling_distill", "WORLD_SCALE_RANGE": [0.95, 1.05]}]}
    cfg["DATASET"] = cls
    return ConfigDict(copy.deepcopy(cfg)), JConfigDict(copy.deepcopy(cfg))


def _gt_database(root):
    """Both packages' ``create_groundtruth_database`` on copies of ``root``;
    returns the two trees."""
    out = []
    for name, mod in (("jax", jig), ("port", tig)):
        tree = root.parent / f"{root.name}_{name}"
        shutil.copytree(root, tree)
        np.random.seed(3)
        mod.create_groundtruth_database(tree, version="v1.0-mini", max_sweeps=2)
        out.append(tree)
    return out


# ---------------------------------------------------------------- pcd

@pytest.mark.parametrize("n, seed", [(17, 0), (1, 5), (300, 7)])
def test_pcd_reads_bit_equal(tmp_path, n, seed):
    path = tmp_path / "r.pcd"
    write_pcd(path, n=n, seed=seed)
    got, fields = tpcd.read_pcd(path)
    want, jfields = jpcd.read_pcd(path)
    assert fields == jfields
    assert_same(got, want)
    assert_same(tpcd.load_radar_points(path), jpcd.load_radar_points(path))


def test_quaternion_helpers_match():
    rng = np.random.RandomState(0)
    for _ in range(8):
        q1, q2 = rng.randn(4).tolist(), rng.randn(4).tolist()
        yaw = float(rng.uniform(-3, 3))
        assert tpcd.yaw_to_quaternion(yaw) == jpcd.yaw_to_quaternion(yaw)
        assert tpcd.quaternion_yaw(q1) == jpcd.quaternion_yaw(q1)
        assert_same(tpcd.quaternion_rotation_matrix(q1), jpcd.quaternion_rotation_matrix(q1))
        assert tpcd.quaternion_multiply(q1, q2) == jpcd.quaternion_multiply(q1, q2)
        assert tpcd.quaternion_inverse(q1) == jpcd.quaternion_inverse(q1)


# ------------------------------------------------------------ datasets

@pytest.mark.parametrize("name", NAMES)
def test_dataset_items_bit_equal_without_augmentation(tmp_path, name):
    root = _tree(tmp_path / "nusc")
    cfg, jcfg = _cfg(root, name, aug=False)
    got = tloader.DATASETS[name](cfg, CLASSES, training=False, root_path=root)
    want = jloader.DATASETS[name](jcfg, CLASSES, training=False, root_path=root)
    assert type(got).__name__ == type(want).__name__ and len(got) == len(want) == 2
    for i in range(2):
        for fn in ("get_item_raw", "__getitem__"):
            items = []
            for ds in (got, want):
                np.random.seed(10 + i)
                items.append(getattr(ds, fn)(i))
            assert_same(*items, path=f"{fn}({i})")


@pytest.mark.parametrize("name", NAMES)
def test_dataset_items_equal_with_augmentation(tmp_path, name):
    root = _tree(tmp_path / "nusc")
    jtree, ttree = _gt_database(root)
    cfg, _ = _cfg(ttree, name, aug=True)
    _, jcfg = _cfg(jtree, name, aug=True)
    got = tloader.DATASETS[name](cfg, CLASSES, training=True, root_path=ttree)
    want = jloader.DATASETS[name](jcfg, CLASSES, training=True, root_path=jtree)
    assert got.data_augmentor.db_sampler is not None
    for i in range(2):
        items = []
        for ds in (got, want):
            np.random.seed(20 + i)
            items.append(ds[i])
        assert_same(*items, path=f"item({i})")


def test_loaders_over_the_tree_match(tmp_path):
    """Both packages' loaders, shuffled and augmented, over two epochs."""
    root = _tree(tmp_path / "nusc")
    jtree, ttree = _gt_database(root)
    runs = []
    for mod, tree, pick in ((tloader, ttree, 0), (jloader, jtree, 1)):
        dcfg = _cfg(tree, "NuScenesDataset_Distill", aug=True)[pick]
        _, ld = mod.build_dataloader(dcfg, CLASSES, 1, root_path=tree, training=True, seed=4)
        np.random.seed(0)
        batches = []
        for epoch in range(2):
            ld.set_epoch(epoch)
            batches += [b for b, _ in ld]
        runs.append(batches)
    assert len(runs[0]) == 4
    assert_same(*runs, path="batches")


# ------------------------------------------------------------ info_gen

def test_create_groundtruth_database_matches(tmp_path):
    jtree, ttree = _gt_database(_tree(tmp_path / "nusc"))
    db = "nuscenes_dbinfos_2sweeps_with_radar_withvelo.pkl"
    got, want = (pickle.loads((t / db).read_bytes()) for t in (ttree, jtree))
    assert_same(got, want, path="dbinfos")
    assert sum(len(v) for v in got.values()) == 6
    crops = sorted(p.name for p in (ttree / "gt_database_2sweeps_with_radar_withvelo").iterdir())
    assert len(crops) == 12
    match, mismatch, errors = filecmp.cmpfiles(
        ttree / "gt_database_2sweeps_with_radar_withvelo",
        jtree / "gt_database_2sweeps_with_radar_withvelo", crops, shallow=False)
    assert not mismatch and not errors and len(match) == 12


def test_gt_database_comes_from_the_train_split(tmp_path):
    """The port's database holds the train split's objects (the reference's);
    the JAX package's reads the val split's infos."""
    root = _tree(tmp_path / "nusc")
    val = pickle.loads((root / INFO_TRAIN.replace("train", "val")).read_bytes())[:1]
    val[0]["gt_boxes"] = val[0]["gt_boxes"][:1]
    (root / INFO_TRAIN.replace("train", "val")).write_bytes(pickle.dumps(val))
    jtree, ttree = _gt_database(root)
    db = "nuscenes_dbinfos_2sweeps_with_radar_withvelo.pkl"
    got, want = (pickle.loads((t / db).read_bytes()) for t in (ttree, jtree))
    assert sum(len(v) for v in got.values()) == 6 and sum(len(v) for v in want.values()) == 1


def _matrix_to_wxyz(m):
    """Unit quaternion [w, x, y, z] of a rotation matrix."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2
    q = [0.0] * 4
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


@pytest.fixture
def stub():
    """``tests/nuscenes_stub.py`` installed in ``sys.modules``, for both
    packages, and taken out after the test."""
    import tests.nuscenes_stub as stub

    names = stub.install()
    yield stub
    for n in names + ["nuscenes.utils.geometry_utils", "nuscenes.utils.splits"]:
        sys.modules.pop(n, None)
    stub.NuScenes._TABLES = {}
    stub.NuScenes._GT = {}


@pytest.fixture
def devkit(stub):
    """The stub plus what ``fill_trainval_infos`` and ``create_nuscenes_infos``
    call that it lacks: ``Quaternion(matrix=)``,
    ``geometry_utils.transform_matrix``, ``splits``, and a record store with
    ``sample``, ``get_boxes`` and ``box_velocity``."""
    class Quaternion(stub.Quaternion):
        def __init__(self, elements=None, axis=None, radians=None, matrix=None):
            if matrix is not None:
                elements = _matrix_to_wxyz(np.asarray(matrix, np.float64))
            super().__init__(elements=elements, axis=axis, radians=radians)

    def transform_matrix(translation, rotation, inverse=False):
        tm = np.eye(4)
        rot = rotation.rotation_matrix
        if inverse:
            tm[:3, :3] = rot.T
            tm[:3, 3] = rot.T.dot(-np.asarray(translation))
        else:
            tm[:3, :3] = rot
            tm[:3, 3] = np.asarray(translation)
        return tm

    geo = types.ModuleType("nuscenes.utils.geometry_utils")
    geo.transform_matrix = transform_matrix
    splits = types.ModuleType("nuscenes.utils.splits")
    splits.mini_train, splits.mini_val = ["scene-0001"], ["scene-0002"]
    splits.train, splits.val, splits.test = ["scene-0001"], ["scene-0002"], []
    for mod in (geo, splits):
        sys.modules[mod.__name__] = mod
        setattr(sys.modules["nuscenes.utils"], mod.__name__.rsplit(".", 1)[1], mod)
    sys.modules["pyquaternion"].Quaternion = Quaternion
    store = _record_store(stub, Quaternion)
    sys.modules["nuscenes.nuscenes"].NuScenes = lambda version, dataroot, verbose=False: store
    return store


def _record_store(stub, Quaternion):
    """Two scenes (train: 2 key frames, val: 1), each key frame with a lidar
    sweep chain of 3 and 5 radar channels of up to 3 sweeps, three annotated
    boxes a frame (one without a velocity), every pose and calibration a
    different yaw and translation."""
    rng = np.random.RandomState(0)
    tables, boxes, velocity, samples = {}, {}, {}, []

    def pose(tok, table):
        yaw = float(rng.uniform(-np.pi, np.pi))
        tables[(table, tok)] = {"rotation": Quaternion(axis=[0, 0, 1], radians=yaw).elements
                                .tolist(), "translation": rng.uniform(-20, 20, 3).tolist()}

    def chain(prefix, n, ts, key):
        toks = [f"{prefix}_{k}" for k in range(n)]
        for k, tok in enumerate(toks):
            pose(f"cs_{tok}", "calibrated_sensor")
            pose(f"ep_{tok}", "ego_pose")
            tables[("sample_data", tok)] = {
                "filename": f"sweeps/{tok}.bin" if k else f"samples/{tok}.bin",
                "prev": toks[k + 1] if k + 1 < n else "", "timestamp": ts - 50_000 * k,
                "calibrated_sensor_token": f"cs_{tok}", "ego_pose_token": f"ep_{tok}",
                "is_key_frame": key and k == 0}
        return toks[0]

    for s, scene in enumerate(("scene-0001", "scene-0001", "scene-0002")):
        tables[("scene", f"sc{scene[-1]}")] = {"name": scene}
        ts = 1_000_000 * (s + 1)
        data = {"LIDAR_TOP": chain(f"lidar{s}", 3, ts, True)}
        for c, chan in enumerate(tig.RADAR_CHANNELS):
            data[chan] = chain(f"radar{s}_{c}", 1 + (c + s) % 3, ts - 7_000 * c, True)
        anns = []
        for b, raw in enumerate(("vehicle.car", "vehicle.truck", "human.pedestrian.adult")):
            tok = f"ann{s}_{b}"
            anns.append(tok)
            tables[("sample_annotation", tok)] = {"num_lidar_pts": int(rng.randint(0, 50)),
                                                  "num_radar_pts": int(rng.randint(0, 5))}
            boxes.setdefault(data["LIDAR_TOP"], []).append(
                (rng.uniform(-30, 30, 3), rng.uniform(0.5, 5, 3),
                 float(rng.uniform(-np.pi, np.pi)), raw, tok))
            velocity[tok] = (np.full(3, np.nan) if b == 2 else rng.uniform(-5, 5, 3))
        samples.append({"token": f"s{s}", "timestamp": ts, "data": data, "anns": anns,
                        "scene_token": f"sc{scene[-1]}"})

    class Store(stub.NuScenes):
        sample = samples

        def get_boxes(self, lidar_token):
            return [stub.Box(c, wlh, Quaternion(axis=[0, 0, 1], radians=yaw), name=raw, token=tok)
                    for c, wlh, yaw, raw, tok in boxes[lidar_token]]

        def box_velocity(self, token):
            return velocity[token].copy()

    stub.NuScenes._TABLES = tables
    return Store()


def test_fill_trainval_infos_matches(devkit):
    got = tig.fill_trainval_infos(devkit, {"scene-0001"}, {"scene-0002"}, max_sweeps=3)
    want = jig.fill_trainval_infos(devkit, {"scene-0001"}, {"scene-0002"}, max_sweeps=3)
    assert [len(x) for x in got] == [2, 1]
    assert_same(got, want, path="infos")
    info = got[0][0]
    assert len(info["sweeps"]) == 2 and info["gt_boxes"].shape == (3, 9)
    assert list(info["gt_names"]) == ["car", "truck", "pedestrian"]
    assert sorted(info["radars"]) == sorted(tig.RADAR_CHANNELS)


def test_create_nuscenes_infos_matches(devkit, tmp_path):
    for name, mod in (("jax", jig), ("port", tig)):
        (tmp_path / name).mkdir()
        mod.create_nuscenes_infos(tmp_path / name, version="v1.0-mini", max_sweeps=3)
    for split in ("train", "val"):
        f = f"nuscenes_infos_6radar_3sweeps_{split}.pkl"
        assert_same(pickle.loads((tmp_path / "port" / f).read_bytes()),
                    pickle.loads((tmp_path / "jax" / f).read_bytes()), path=f)


def test_info_generation_needs_the_devkit(tmp_path):
    with pytest.raises(RuntimeError, match="nuscenes-devkit"):
        tig.create_nuscenes_infos(tmp_path)


# -------------------------------------------------------- eval_bridge

def _quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _official_case(stub, version):
    token = "tok0"
    stub.NuScenes._TABLES = {
        ("sample", token): {"data": {"LIDAR_TOP": "sd0"}},
        ("sample_data", "sd0"): {"calibrated_sensor_token": "cs0", "ego_pose_token": "ep0"},
        ("calibrated_sensor", "cs0"): {"rotation": _quat(np.pi / 2), "translation": [1, 2, .5]},
        ("ego_pose", "ep0"): {"rotation": _quat(np.pi), "translation": [10.0, -5.0, 0.0]},
    }
    stub.NuScenes._GT = {token: (np.array([
        [13.0, -10.0, 1.5, 4.0, 2.0, 1.5, 0.3 - 0.5 * np.pi, 0.0, -1.0],
        [50.0, 50.0, 0.0, 0.5, 0.5, 1.7, 0.0, 0.0, 0.0]]), ["car", "pedestrian"])}
    det = {"metadata": {"token": token},
           "pred_boxes": np.array([[3.0, 4.0, 1.0, 4.0, 2.0, 1.5, 0.3, 1.0, 0.0],
                                   [-3.0, 1.0, 0.5, 0.6, 0.6, 1.8, 1.0, 0.1, 0.1]]),
           "pred_scores": np.array([0.9, 0.4]), "pred_labels": np.array([1, 9]),
           "name": np.array(["car", "pedestrian"])}
    return types.SimpleNamespace(dataset_cfg={"VERSION": version}, root_path=Path(".")), [det]


@pytest.mark.parametrize("version", ["v1.0-mini", "v1.0-test"])
def test_official_eval_matches(stub, tmp_path, version):
    dataset, dets = _official_case(stub, version)
    res = {}
    for name, mod in (("jax", jeb), ("port", teb)):
        res[name] = mod.evaluate_nuscenes(dataset, dets, ["car", "pedestrian"],
                                          output_path=str(tmp_path / name))
    assert res["port"] == res["jax"]
    sub = [json.loads((tmp_path / n / "results_nusc.json").read_text()) for n in ("port", "jax")]
    assert sub[0] == sub[1] and len(sub[0]["results"]["tok0"]) == 2
    summary = [tmp_path / n / "metrics_summary.json" for n in ("port", "jax")]
    if version == "v1.0-test":  # no annotations: the submission only
        assert res["port"] == ("No ground-truth annotations for evaluation", {})
        assert not any(p.exists() for p in summary)
    else:
        assert json.loads(summary[0].read_text()) == json.loads(summary[1].read_text())
        assert res["port"][1]["mAP"] == pytest.approx(0.5)


def _detections(infos, seed=0):
    rng = np.random.RandomState(seed)
    dets = []
    for info in infos:
        boxes = info["gt_boxes"] + rng.normal(0, 0.3, info["gt_boxes"].shape).astype(np.float32)
        dets.append({"pred_boxes": boxes, "pred_scores": rng.uniform(0.1, 1, len(boxes)),
                     "pred_labels": np.ones(len(boxes), np.int64), "name": info["gt_names"],
                     "metadata": {"token": info["token"]}, "frame_id": info["token"]})
    return dets


def _jax_fallback(want, dets, classes):
    """What the JAX package's ``_fallback_eval`` computes for ``dets``: its
    ``detection_metrics`` over the infos' GT, and its table of them read back
    from json, as the devkit leg reads them (its own ``_fallback_eval``
    raises: ``format_nuscene_results`` joins the float thresholds as
    strings)."""
    token_to_info = {info["token"]: info for info in want.infos}
    infos = [token_to_info[d["metadata"]["token"]] for d in dets]
    metrics = jeb.detection_metrics(
        [i["gt_boxes"] for i in infos], [i["gt_names"] for i in infos],
        [d["pred_boxes"] for d in dets], [d["pred_scores"] for d in dets],
        [d["name"] for d in dets], classes)
    with pytest.raises(TypeError):
        jeb.format_nuscene_results(metrics, classes)
    return metrics, jeb.format_nuscene_results(
        json.loads(json.dumps(metrics)), classes,
        version="internal center-distance (devkit absent)")


@pytest.mark.parametrize("name", NAMES)
def test_fallback_eval_and_dataset_evaluation_match(tmp_path, name):
    assert "nuscenes" not in sys.modules  # the devkit is absent: the fallback leg
    root = _tree(tmp_path / "nusc")
    cfg, jcfg = _cfg(root, name, aug=False)
    got = tloader.DATASETS[name](cfg, CLASSES, training=False, root_path=root)
    want = jloader.DATASETS[name](jcfg, CLASSES, training=False, root_path=root)
    dets = _detections(got.infos)
    metrics, table = _jax_fallback(want, dets, CLASSES)
    res = got.evaluation(copy.deepcopy(dets), CLASSES, output_path=str(tmp_path / "port"))
    assert res == table and "devkit absent" in res[0] and res[1]["mAP"] > 0
    assert (json.loads((tmp_path / "port" / "metrics_internal.json").read_text())
            == json.loads(json.dumps(metrics)))
    assert teb._fallback_eval(got, dets, CLASSES, str(tmp_path / "direct")) == table


def test_format_nuscene_results_matches():
    rng = np.random.RandomState(1)
    classes = ["car", "truck", "barrier", "traffic_cone"]
    gt_b = [rng.uniform(-10, 10, (6, 9)) for _ in range(3)]
    gt_n = [rng.choice(classes, 6) for _ in range(3)]
    det_b = [g + rng.normal(0, 0.5, g.shape) for g in gt_b]
    det_s = [rng.uniform(0, 1, 6) for _ in range(3)]
    metrics = teb.detection_metrics(gt_b, gt_n, det_b, det_s, gt_n, classes)
    assert_same(metrics, jeb.detection_metrics(gt_b, gt_n, det_b, det_s, gt_n, classes))
    from_json = json.loads(json.dumps(metrics))  # the devkit's metrics_summary.json
    for version in ("detection_cvpr_2019", "internal"):
        want = jeb.format_nuscene_results(from_json, classes, version)
        assert teb.format_nuscene_results(from_json, classes, version) == want
        assert teb.format_nuscene_results(metrics, classes, version) == want


# ----------------------------------------- the shipped yamls and the tree

def test_shipped_yamls_expand_the_dataset_base():
    """``DATA_CONFIG``'s nested ``_BASE_CONFIG_`` is expanded (the reference's
    loader does it; the JAX package's keeps the key), so the shipped yamls
    name their nuScenes datasets."""
    from radardistill_tpu_torch.config import cfg_from_yaml_file

    repo = Path(__file__).resolve().parent.parent / "tools" / "cfgs" / "radar_distill"
    for yaml_name, name in (("radar_distill_train.yaml", "NuScenesDataset_Distill"),
                            ("radar_distill_val.yaml", "NuScenesDataset_radar_test")):
        data = cfg_from_yaml_file(repo / yaml_name, ConfigDict()).DATA_CONFIG
        assert data.DATASET == name and "_BASE_CONFIG_" not in data
        assert data.CAPACITIES.MAX_RADAR_POINTS == 8192
        assert data.POINT_CLOUD_RANGE == [-54.0, -54.0, -5.0, 54.0, 54.0, 3.0]


def test_nuscenes_tree_tool_writes_what_the_datasets_read(tmp_path):
    """``tools/torch_nuscenes_tree.py`` (the card's phase 26 tree): nuScenes'
    widths, read by the port's datasets as the JAX package's read them."""
    from tools.torch_nuscenes_tree import LIDAR_POINTS, make_tree

    train, val = make_tree(tmp_path, 1, 1)
    assert len(train) == len(val) == 1 and 40 <= len(train[0]["gt_boxes"]) <= 60
    assert (train[0]["num_lidar_pts"] > 5).all()
    cfg, jcfg = _cfg(tmp_path, "NuScenesDataset_Distill", aug=False)
    for c in (cfg, jcfg):
        c.MAX_SWEEPS = 10
        c.INFO_PATH = {"test": ["nuscenes_infos_6radar_10sweeps_val.pkl"]}
    got = tds.NuScenesDatasetDistill(cfg, CLASSES, training=False, root_path=tmp_path)
    want = jds.NuScenesDatasetDistill(jcfg, CLASSES, training=False, root_path=tmp_path)
    items = []
    for ds in (got, want):
        np.random.seed(0)
        items.append(ds.get_item_raw(0))
    assert_same(*items)
    pts = items[0]["points"]
    assert len(pts) > 9 * LIDAR_POINTS and 5 * 6 * 90 <= len(items[0]["radar_points"])
    inside = (np.abs(pts[:, :2]) <= 54).all(1) & (pts[:, 2] >= -5) & (pts[:, 2] <= 3)
    assert 150_000 < inside.sum() < 170_000
