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


def maybe_init_distributed():
    """One process: a no-op that returns False. ``WORLD_SIZE`` above 1 (what
    ``torchrun`` exports, the counterpart of ``JAX_PROCESS_COUNT``) raises:
    multi-process training is ROADMAP queue 1 item 13, not ported."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return False
    raise NotImplementedError(
        f"WORLD_SIZE={n}: multi-process runs are not ported (ROADMAP queue 1, item 13)")
