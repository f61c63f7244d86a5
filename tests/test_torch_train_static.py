"""The port's distillation train step against the JAX package, float32, CPU,
with the teacher's ``INT8: static`` as shipped (``tests/torch_train_case.py``
states the case and its tolerances; ``tests/test_torch_train.py`` runs it
with ``INT8: false``).
"""

import pytest
import torch

from tests.torch_train_case import (  # noqa: F401  the tests of the case, collected here
    test_loss_and_terms_at_init_match_jax,
    test_gradients_at_init_match_jax,
    test_gradient_global_norm_and_frozen_leaves_match_jax,
    test_loss_of_each_step_matches_jax,
    test_parameters_after_steps_match_jax,
    test_bn_statistics_after_steps_match_jax,
    test_frozen_leaves_are_bit_equal_after_steps,
    test_eval_forward_after_training_decodes,
    make_inputs, make_run)

# Six xdist workers share the machine's cores: one intra-op thread per worker
# keeps torch's thread pools from oversubscribing them (the suite is bound by
# its total CPU time). The tolerances of the case hold for any thread count.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def inputs():
    return make_inputs()


@pytest.fixture(scope="module", params=["static"], ids=["int8-static"])
def run(request, inputs):
    return make_run(inputs, request.param)
