"""The space-to-depth LiDAR teacher (``PillarRes18BackBone8x_S2D`` on the dense
VFE's grid, ``TABLE_INPUT`` absent) trained on its own in ``pillarnet.yaml``'s
topology (``DISTILL`` absent, no ``FREEZE_PIPELINE``) against the JAX package,
float32, CPU: the eval forward with its decode, then two train steps through
each package's ``make_train_step``. ``tests/torch_dense_case.py`` states the
case and its tolerances; ``tests/test_torch_dense_teacher.py`` runs it on the
dense ``PillarRes18BackBone8x``, whose ``state_dict`` this teacher shares.
"""

import pytest
import torch

from tests.torch_dense_case import (  # noqa: F401  the tests of the case, collected here
    make_run, make_setup,
    test_eval_forward_matches_jax,
    test_loss_and_terms_at_init_match_jax,
    test_gradients_at_init_match_jax,
    test_parameters_and_statistics_after_steps_match_jax)

# one intra-op thread per xdist worker (the suite is bound by its CPU time);
# the tolerances hold for any thread count
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return make_setup("s2d_teacher")


@pytest.fixture(scope="module")
def run(setup):
    return make_run(setup)


def test_the_teacher_is_the_space_to_depth_one_and_trains(setup):
    from radardistill_tpu_torch.models.backbone_s2d import PillarRes18BackBone8xS2D

    bb = setup["model"].backbone_3d
    assert isinstance(bb, PillarRes18BackBone8xS2D) and not bb.table_input
    assert "backbone_3d" not in setup["model"].frozen
