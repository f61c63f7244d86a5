"""Multi-process result merging.

Counterpart of ``radardistill_tpu/parallel/multihost.py``. Reference
mechanism: merge_results_dist — every rank pickles its detection list to a
shared tmpdir, rank 0 concatenates after a barrier
(pcdet/utils/common_utils.py:236-257), plus object all_gather over NCCL
(commu_utils.py:50-112 all_gather_object / average_reduce_value).

The port gathers pickled objects with ``torch.distributed.all_gather_object``
on a gloo group of its own: host objects never cross the card, and the
group's timeout is long (30 min), so eval ranks that reach the merge minutes
apart do not time out. Semantics are the JAX package's: whole per-sample
dicts (variable-length boxes, ``name``, ``frame_id``, nested ``metadata``)
survive the merge, concatenated in rank order, with no box cap; one process
is the identity.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch.distributed as dist

_TIMEOUT = datetime.timedelta(minutes=30)
_GROUP = {}  # the default group -> its gloo twin


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _gloo_group():
    """A gloo group over every rank of the default group, made once per
    default group (every rank makes it at the same call, its first gather)."""
    world = dist.group.WORLD
    if world not in _GROUP:
        _GROUP.clear()
        _GROUP[world] = dist.new_group(backend="gloo", timeout=_TIMEOUT)
    return _GROUP[world]


def all_gather_object(obj):
    """One picklable object per process, gathered to every process; a list
    of length ``process_count()`` in rank order."""
    n = process_count()
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=_gloo_group())
    return out


def gather_detections(det_annos):
    """Every process's detection list (``generate_prediction_dicts``'s
    per-sample dicts), concatenated in rank order, on every process. One
    process: ``det_annos`` itself."""
    if process_count() == 1:
        return det_annos
    out = []
    for part in all_gather_object(list(det_annos)):
        out.extend(part)
    return out


def barrier():
    """Wait for every process (on the gloo group, with its long timeout)."""
    if process_count() > 1:
        dist.barrier(group=_gloo_group())


def psum_scalar(value: float) -> float:
    """Cross-process scalar SUM (additive counters)."""
    return float(np.sum(all_gather_object(float(value))))


def pmean_scalar(value: float) -> float:
    """Cross-process scalar MEAN (reference: commu_utils.average_reduce_value,
    used for loss logging in the DDP train loop)."""
    return float(np.mean(all_gather_object(float(value))))
