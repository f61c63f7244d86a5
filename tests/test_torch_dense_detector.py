"""Whole detectors of the dense-input route against the JAX package, float32,
CPU, eval forward with its decode: the ``synthetic/smoke.yaml`` topology (a
dense LiDAR teacher, frozen, beside a dense radar branch, ``DISTILL: True``)
and an ``_AS`` LiDAR teacher alone (its pillar table and tap tables from
``HostPrecompute``'s ``hp_lidar`` / ``hp_as_lidar``). Also: the ``ckpt.py``
surgery onto the dense radar backbone against the JAX surgery, and the
teachers' one parameter tree: the dense teacher's ``state_dict`` has the keys
and shapes of the space-to-depth teacher's, and a checkpoint of the dense
teacher loads in full into the S2D teacher, which then computes the same
``x_conv4`` / ``x_conv5``.

``tests/torch_dense_case.py`` states the configurations, the batch, the
weights and the tolerances (features and predictions rel-L2 <= 1e-4,
detections entry by entry with near-tie swaps allowed).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from radardistill_tpu_torch.config import ConfigDict
from radardistill_tpu_torch.convert import state_dict_from_jax
from radardistill_tpu_torch.data.host_precompute import HostPrecompute
from radardistill_tpu_torch.models import build_network
from radardistill_tpu_torch.models.layers import init_random_
from radardistill_tpu_torch.train.checkpoint import CheckpointManager
from radardistill_tpu_torch.train.train_step import create_train_state
from tests.test_torch_slice import _rel_l2
from tests.torch_dense_case import OPTIM, assert_eval_matches, make_setup, model_cfg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke():
    return make_setup("smoke")


@pytest.fixture(scope="module", params=["smoke", "as_teacher"])
def evaluated(request, smoke):
    setup = smoke if request.param == "smoke" else make_setup(request.param)
    jmodel = setup["jmodel"]
    jout = jax.tree.map(np.asarray, jax.jit(lambda v, b: jmodel.apply(v, b, False))(
        setup["variables"], setup["jbatch"]))
    return setup, jout, setup["model"].eval()(setup["tbatch"])


def test_eval_forward_matches_jax(evaluated):
    setup, jout, tout = evaluated
    smoke = setup["kind"] == "smoke"
    assert_eval_matches(jout, tout, ["teacher", "radar"] if smoke else ["teacher"])
    if smoke:  # the teacher's head runs in eval beside the radar's
        assert set(tout["lidar_preds"]) == set(jout["lidar_preds"])
    else:
        assert type(setup["model"].backbone_3d).__name__ == "PillarRes18BackBone8xAS"
        assert "hp_as_lidar" in setup["tbatch"] and "hp_masks" not in setup["tbatch"]


def test_duplicate_teacher_to_radar_onto_the_dense_radar_backbone_matches_jax(smoke):
    """The surgery on the bridged JAX variables of the smoke topology equals
    the JAX surgery bridged, parameters and BN statistics alike; the radar
    backbone's stage-1 kernels are HWIO on both sides and copy as they are."""
    from radardistill_tpu.train.checkpoint import duplicate_teacher_to_radar as j_duplicate
    from radardistill_tpu_torch.train.checkpoint import duplicate_teacher_to_radar

    variables, model = smoke["variables"], smoke["model"]
    want = state_dict_from_jax(model, {k: j_duplicate(v) for k, v in variables.items()})
    raw = state_dict_from_jax(model, variables)
    got = duplicate_teacher_to_radar(raw)
    assert sorted(got) == sorted(want)
    copied = [k for k in want if not torch.equal(want[k], raw[k])]
    assert "radar_backbone_3d.conv1_0.conv1.conv.kernel" in copied
    assert len([k for k in copied if k.startswith("radar_backbone_3d.")]) > 100
    assert all(torch.equal(got[k], want[k]) for k in want)


def _teacher_pair():
    """The dense teacher of ``pillarnet.yaml``'s topology and the table-input
    S2D teacher of ``radar_distill_train.yaml`` (``INT8: false``), on one
    configuration but for ``BACKBONE_3D``."""
    _, dense_cfg, info = model_cfg("teacher")
    s2d_cfg = copy.deepcopy(dense_cfg)
    s2d_cfg.BACKBONE_3D = ConfigDict(NAME="PillarRes18BackBone8x_S2D", TABLE_INPUT=True,
                                     TABLE_CAPACITY=4096, INT8=False)
    return dense_cfg, s2d_cfg, info


def test_dense_and_s2d_teachers_share_one_state_dict():
    dense_cfg, s2d_cfg, info = _teacher_pair()
    dense = build_network(dense_cfg, info, device="cpu").state_dict()
    s2d = build_network(s2d_cfg, info, device="cpu").state_dict()
    assert sorted(dense) == sorted(s2d)
    assert all(dense[k].shape == s2d[k].shape for k in dense)
    assert dense["backbone_3d.conv1_0.conv1.conv.kernel"].shape == (3, 3, 32, 32)  # HWIO
    assert dense["backbone_3d.conv2_down.conv.conv.kernel"].shape == (3, 3, 32, 64)


def test_dense_teacher_checkpoint_loads_in_full_into_the_s2d_teacher(tmp_path):
    """A checkpoint of the dense teacher, loaded as ``--pretrained_model``
    loads it into the S2D teacher: every entry taken, and the two teachers
    compute the same features from the same points."""
    from radardistill_tpu_torch.data import collate, synthetic
    from radardistill_tpu_torch.models.detector import batch_to_torch

    dense_cfg, s2d_cfg, info = _teacher_pair()
    gen = torch.Generator().manual_seed(3)
    dense, _ = create_train_state(build_network(dense_cfg, info, device="cpu"),
                                  ConfigDict(OPTIM), 10, gen)
    init_random_(dense.model, gen)  # BN statistics away from 0 / 1
    path = CheckpointManager(tmp_path).save(dense, epoch=1)
    s2d, _ = create_train_state(build_network(s2d_cfg, info, device="cpu"), ConfigDict(OPTIM), 10)
    CheckpointManager(tmp_path).load_params_from_file(s2d, path)
    assert s2d.loaded == len(s2d.model.state_dict()) == len(dense.model.state_dict())

    scenes = [synthetic.make_scene(s, num_lidar=1500, num_radar=10, num_boxes=5,
                                   pc_range=info["point_cloud_range"]) for s in (0, 1)]
    batch = collate.collate_batch(scenes, {"MAX_LIDAR_POINTS": 1536, "NUM_MAX_OBJS": 16})
    batch.pop("_host", None)
    geo = (info["grid_size"], info["voxel_size"], info["point_cloud_range"])
    outs = []
    for state, cfg in ((dense, dense_cfg), (s2d, s2d_cfg)):
        b = batch_to_torch(HostPrecompute(cfg, *geo)(copy.deepcopy(batch)), "cpu")
        with torch.no_grad():
            outs.append(state.model.eval()(b))
    assert "hp_masks" in b  # the S2D teacher's batch
    for k in ("x_conv4", "x_conv5", "spatial_features_2d"):
        assert np.abs(outs[0][k].numpy()).max() > 0
        assert _rel_l2(outs[1][k].numpy(), outs[0][k].numpy()) <= 1e-4, k
