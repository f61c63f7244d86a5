"""Data-parallel training of the port on the card (marked ``gpu``; they skip
without one): ``tools/torch_ddp_check.py``'s two checks on
``radar_distill_train.yaml`` at full width (1440², 160 000 lidar points and
3000 radar returns a scene, bs2), as ``chip_smoke.py`` phase 27 runs them.

- NCCL at world size 1: the DDP + synchronized-BN step against the unwrapped
  step of the same weights, loss rel <= 1e-6, every parameter within 1e-6
  rel-L2 but the leaves whose true gradient is zero (within 2.1·lr).
- Two ranks on the one card (gloo: NCCL refuses two ranks on one card), bs1
  each, against one process on the bs2 batch, float32: synchronized leg loss
  rel <= 1e-4 and the parameter rule of ``tests/torch_train_case.py``; local
  leg running statistics equal to the mean of the ranks' local updates; each
  rank's step launches the train step's kernels.

The file imports neither JAX nor flax, so it runs where only the port is
installed: ``python -m pytest tests/test_torch_ddp_card.py -q -m gpu``.
"""

import pytest
import torch

STEP = {"expand_rows": 2, "dcn_sample": 3, "conv_block": 4, "dcn_offset_grad": 3,
        "dcn_input_grad": 3}


@pytest.fixture(scope="module")
def case():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README)")
    from radardistill_tpu_torch.data.synthetic import make_batch
    from radardistill_tpu_torch.utils.production import TRAIN_YAML

    return torch.device("cuda", 0), make_batch(TRAIN_YAML)


@pytest.mark.gpu
def test_ddp_at_world_size_1_on_nccl_equals_the_unwrapped_step(case):
    from tools.torch_ddp_check import world1_nccl

    dev, (cfg, info, batch) = case
    res = world1_nccl(torch, dev, cfg, info, batch, runs=1)
    assert res["loss_rel"] <= 1e-6 and res["worst_param_rel_l2"] <= 1e-6


@pytest.mark.gpu
def test_two_ranks_on_the_card_match_one_process(case, tmp_path):
    from tools.torch_ddp_check import two_ranks

    dev, (cfg, info, batch) = case
    res = two_ranks(torch, dev, cfg, info, batch, tmp_path, STEP)
    assert res["loss_rel"] <= 1e-4 and res["stats_rel_l2"] <= 1e-5
