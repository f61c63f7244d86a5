"""Trainer: the epoch loop driving the train step.

Reference: tools/train_utils/train_utils.py — train_one_epoch (:13-155:
scheduler step per iter, AMP fwd/bwd, clip, logging, time-interval
latest_model save) and train_model (:158-251: epoch loop, ckpt rotation,
DisableAugmentationHook :296-311).

Counterpart of ``radardistill_tpu/train/trainer.py``. The step
(``train_step.make_train_step``) returns device tensors and never waits for
the card; the trainer is orchestration: data iteration, hooks, logging,
checkpoints. Batches reach the card through ``_DevicePrefetcher`` (pinned
host memory, a copy stream), and the metrics of a logged step are read back
one step late, in one copy. Under data parallelism every rank runs the loop
on its slice of the data; the logged loss is the mean over the ranks
(``pmean_scalar``), rank 0 alone logs and writes checkpoints, and every rank
waits at the end until the last checkpoint is written.
"""

from __future__ import annotations

import queue
import re
import threading
import time
from pathlib import Path
from typing import Callable

import torch

from ..models.detector import batch_to_torch
from ..parallel.multihost import barrier, pmean_scalar
from ..utils.common import AverageMeter
from ..utils.profiler import span
from .checkpoint import CheckpointManager

_END = object()
# the line train_model logs for a step, as read_log parses it back
LOG_LINE = re.compile(r"epoch (\d+)/(\d+) it (\d+)/(\d+) loss (\S+) lr \S+ "
                      r"t_iter ([\d.]+)\([\d.]+\)s t_data ([\d.]+)\(")


def read_log(path):
    """(epoch, total epochs, it, steps per epoch, loss, t_iter s, t_data s) of
    every step a train log records."""
    rows = [LOG_LINE.search(ln) for ln in Path(path).read_text().splitlines()]
    return [(int(m[1]), int(m[2]), int(m[3]), int(m[4]), float(m[5]), float(m[6]), float(m[7]))
            for m in rows if m]


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


class _DevicePrefetcher:
    """Host->device double buffering: a background thread pulls host batches
    and copies them to ``device``, keeping up to ``depth`` batches in flight
    while the current step computes. On the card the copies run from pinned
    memory on a copy stream of their own; the consumer's (current) stream
    waits on each batch's event, and every copied tensor is recorded on that
    stream, so the allocator reuses its memory only after the step that read
    it. The copy stream is current in the background thread only (PyTorch's
    current stream is per thread), so the step's kernels, launched on the
    consumer's current stream, never run on it. ``device`` None hands the
    batches on as they come. Loader exceptions are re-raised in the
    consumer. The consumer's wait for each batch (the trainer's ``t_data``)
    is the span ``data_wait``."""

    def __init__(self, loader, device, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._device = None if device is None else torch.device(device)
        cuda = self._device is not None and self._device.type == "cuda"
        copy_stream = torch.cuda.Stream(self._device) if cuda else None

        def work():
            try:
                for batch, _host in loader:
                    if self._device is None:
                        self._q.put((batch, None))
                        continue
                    host = batch_to_torch(batch, "cpu")
                    if not cuda:
                        self._q.put((host, None))
                        continue
                    host = _map_tensors(torch.Tensor.pin_memory, host)
                    with torch.cuda.stream(copy_stream):
                        dev = _map_tensors(
                            lambda t: t.to(self._device, non_blocking=True), host)
                        done = torch.cuda.Event()
                        done.record(copy_stream)
                    self._q.put((dev, done))
                self._q.put(_END)
            except BaseException as e:  # noqa: BLE001 — surface in consumer
                self._q.put(e)

        self._t = threading.Thread(target=work, daemon=True, name="dev-prefetch")
        self._t.start()

    def __iter__(self):
        while True:
            with span("data_wait"):
                item = self._q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(self._device)
                stream.wait_event(done)
                _map_tensors(lambda t: t.record_stream(stream), batch)
            yield batch


class _MetricsCopy:
    """The scalar metrics of one step, packed into one device vector and
    copied to (pinned) host memory without waiting; ``read()`` waits for that
    copy alone and returns the dict of floats."""

    def __init__(self, metrics: dict):
        self.keys = list(metrics)
        packed = torch.stack([torch.as_tensor(v).detach().reshape(()).to(torch.float64)
                              for v in metrics.values()])
        self.done = None
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host = packed

    def read(self) -> dict:
        if self.done is not None:
            self.done.synchronize()
        return dict(zip(self.keys, self.host.tolist()))


def disable_augmentation_hook(hook_cfg, dataloader, total_epochs, cur_epoch, cfg, logger):
    """Swap the augmentor queue for the last NUM_LAST_EPOCHS epochs
    (train_utils.py:296-311; config HOOK.DisableAugmentationHook)."""
    if hook_cfg is None:
        return
    num_last = hook_cfg.get("NUM_LAST_EPOCHS", 0)
    if cur_epoch >= total_epochs - num_last:
        aug = dataloader.dataset.data_augmentor
        if aug is not None:
            new_cfg = dict(cfg["DATA_CONFIG"]["DATA_AUGMENTOR"])
            new_cfg["DISABLE_AUG_LIST"] = hook_cfg["DISABLE_AUG_LIST"]
            if logger:
                logger.info(f"disable augmentations {hook_cfg['DISABLE_AUG_LIST']} at epoch {cur_epoch}")
            aug.disable_augmentation(new_cfg)


def train_model(
    train_step: Callable,
    state,
    train_loader,
    lr_sched,
    cfg,
    total_epochs: int,
    ckpt_dir,
    start_epoch: int = 0,
    logger=None,
    tb_writer=None,
    ckpt_save_interval: int = 1,
    max_ckpt_save_num: int = 30,
    ckpt_save_time_interval: float = 300.0,
    device=None,
    log_interval: int = 50,
    start_it: int = 0,
):
    """Returns ``state`` (a ``TrainState``, which ``train_step(batch) ->
    metrics`` updates in place). ``device``: where the prefetcher puts each
    batch (None: batches go to the step as the loader yields them).
    `start_it`: mid-epoch resume point within `start_epoch` (reference
    train_one_epoch continues at accumulated_iter after a latest_model
    resume, train_utils.py:158-251)."""
    ckpt_mgr = CheckpointManager(ckpt_dir, max_ckpt_save_num)
    hook_cfg = cfg.get("HOOK", {}).get("DisableAugmentationHook", None)

    it_meter, data_meter = AverageMeter(), AverageMeter()
    last_latest_save = time.time()

    for epoch in range(start_epoch, total_epochs):
        disable_augmentation_hook(hook_cfg, train_loader, total_epochs, epoch, cfg, logger)
        train_loader.set_epoch(epoch)
        if epoch == start_epoch and start_it > 0:
            if hasattr(train_loader, "set_start_iter"):
                train_loader.set_start_iter(start_it)
                if logger:
                    logger.info(f"mid-epoch resume: skipping {start_it} iters of epoch {epoch}")
        spe = len(train_loader)

        def _flush(pending):
            """Read back and log the metrics of an earlier step. Runs AFTER
            the next step has been enqueued, so the copy overlaps it: one
            copy of the whole metrics dict, not one ``float()`` a key (each
            a synchronization)."""
            if pending is None:
                return
            p_i, p_metrics, p_it, p_data = pending
            m = p_metrics.read()
            loss = pmean_scalar(m["loss"])
            it_off = start_it if epoch == start_epoch else 0
            gstep = epoch * spe + it_off + p_i + 1
            lr = float(lr_sched(gstep)) if lr_sched else 0.0
            if logger:
                # val(avg) like the reference's meters
                # (tools/train_utils/train_utils.py:73-124)
                sat = f" dcn_sat {m['dcn_offset_sat']:.2e}" if "dcn_offset_sat" in m else ""
                logger.info(
                    f"epoch {epoch}/{total_epochs} it {p_i}/{spe} "
                    f"loss {loss:.4f} lr {lr:.3e} "
                    f"t_iter {p_it:.3f}({it_meter.avg:.3f})s "
                    f"t_data {p_data:.3f}({data_meter.avg:.3f})s{sat}"
                )
            if tb_writer is not None:
                tb_writer.add_scalar("train/loss", loss, gstep)
                tb_writer.add_scalar("meta_data/learning_rate", lr, gstep)
                for k, v in m.items():
                    if k != "loss":
                        tb_writer.add_scalar(f"train/{k}", v, gstep)

        pending = None
        t_end = time.time()
        for i, batch in enumerate(_DevicePrefetcher(train_loader, device)):
            data_meter.update(time.time() - t_end)  # wait on the prefetcher
            metrics = train_step(batch)  # enqueued, not waited for
            # lag-1: read the PREVIOUS logged step's metrics while this step
            # computes and the next batch copies
            _flush(pending)
            pending = None
            if (i % log_interval) == 0 or i == spe - 1:
                it_meter.update(time.time() - t_end)
                pending = (i, _MetricsCopy(metrics), it_meter.val, data_meter.val)
            # time-interval latest save (train_utils.py:143-151)
            if time.time() - last_latest_save > ckpt_save_time_interval:
                ckpt_mgr.save(state, epoch, tag="latest")
                last_latest_save = time.time()
            t_end = time.time()
        _flush(pending)

        if (epoch + 1) % ckpt_save_interval == 0 or epoch == total_epochs - 1:
            ckpt_mgr.save(state, epoch + 1)
            if logger:
                logger.info(f"saved checkpoint_epoch_{epoch + 1}")
    barrier()  # every rank reads rank 0's checkpoints from here on
    return state
