"""The radar-only baseline of ``pillarnet_radar.yaml`` (the dense radar branch
alone, ``DISTILL: False``) against the JAX package, float32, CPU: the eval
forward with its decode, then two train steps through each package's
``make_train_step``. ``tests/torch_dense_case.py`` states the case and its
tolerances; ``tests/test_torch_dense_teacher.py`` runs it on the LiDAR
teacher.
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
    return make_setup("radar")


@pytest.fixture(scope="module")
def run(setup):
    return make_run(setup)
