"""Common utilities: logging, seeding, meters.

Reference: pcdet/utils/common_utils.py (rank-aware logger :110-124, seeding
:127-137, AverageMeter :287-302). The port's copy of
``radardistill_tpu/utils/common.py``.
"""

from __future__ import annotations

import logging
import os
import random

import numpy as np


def create_logger(log_file=None, rank=0, log_level=logging.INFO):
    """The rank's logger, to the console and to ``log_file``. Each call sets
    its handlers anew, so a second run in one process logs to its own file."""
    logger = logging.getLogger(f"radardistill_tpu_torch.rank{rank}")
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    console = logging.StreamHandler()
    console.setLevel(log_level if rank == 0 else logging.ERROR)
    console.setFormatter(formatter)
    logger.addHandler(console)
    if log_file is not None:
        fh = logging.FileHandler(log_file)
        fh.setLevel(log_level if rank == 0 else logging.ERROR)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


def set_random_seed(seed):
    """Seed Python's, numpy's and torch's global generators. The port's
    initial weights do not come from these: ``create_train_state`` draws
    them from the ``torch.Generator`` it is given."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def dist_env():
    """What ``torchrun`` exports: (world size, rank, local rank, ranks on
    this host); 1, 0, 0, the world size when unset."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    return (world, int(os.environ.get("RANK", "0")), int(os.environ.get("LOCAL_RANK", "0")),
            int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))


def maybe_init_distributed(device="cuda"):
    """One process (``WORLD_SIZE`` unset or 1): a no-op that returns False.
    Under ``torchrun`` (``WORLD_SIZE`` > 1): initializes the default process
    group from ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``
    (the counterpart of ``jax.distributed.initialize``) and returns True. On
    the card the process takes ``cuda:LOCAL_RANK`` and the backend is NCCL,
    or gloo when this host runs more ranks than it has cards (NCCL refuses
    two ranks on one card; they share the cards in turn); on the CPU it is
    gloo. A group already initialized is kept."""
    world, rank, local_rank, local_world = dist_env()
    if world <= 1:
        return False
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    backend = "gloo"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(f"WORLD_SIZE={world} on the card, but no card is visible")
        torch.cuda.set_device(local_rank % cards)
        backend = "nccl" if local_world <= cards else "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    return True
