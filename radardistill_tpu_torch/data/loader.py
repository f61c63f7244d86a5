"""Dataloader builder.

Reference: pcdet/datasets/__init__.py:41-93 (registry lookup,
DistributedSampler slicing, worker seeding, collate binding).

The port's copy of ``radardistill_tpu/data/loader.py``, line for line apart
from the registry: the loader yields (batch, host_meta) pairs where batch is
the fixed-capacity padded numpy dict (``models.detector.batch_to_torch`` or
the trainer's prefetcher moves it to the card). With workers > 0 the
per-sample pipeline (augment + encode + pad) runs in forked torch CPU worker
processes, which touch no CUDA state; the ``batch_transform``
(``HostPrecompute``) runs on the prefetch thread of the parent.
``DATASETS`` registers the four nuScenes datasets under the reference's names
and ``SyntheticDataset``. Under data parallelism each process reads its slice
of the (shuffled) indices, ``idx[process_index::process_count]``, as the
reference's DistributedSampler does.
"""

from __future__ import annotations

import numpy as np

from .dataset import DatasetTemplate, SyntheticDataset
from .nuscenes.dataset import (NuScenesDataset, NuScenesDatasetDistill, NuScenesDatasetRadar,
                               NuScenesDatasetRadarTest)

# registry names mirror the reference's __all__ (pcdet/datasets/__init__.py:24-38)
DATASETS = {
    "NuScenesDataset_Distill": NuScenesDatasetDistill,
    "NuScenesDataset_radar": NuScenesDatasetRadar,
    "NuScenesDataset_radar_test": NuScenesDatasetRadarTest,
    "NuScenesDataset": NuScenesDataset,
    "SyntheticDataset": SyntheticDataset,
}


class DataLoader:
    """Iterates dataset indices -> collated fixed-shape batches.

    With workers > 0 the per-sample pipeline (augment + encode + pad) runs in
    torch CPU worker processes (the reference's dataloader machinery,
    tools/train.py:96-101)."""

    def __init__(self, dataset: DatasetTemplate, batch_size: int, shuffle: bool,
                 seed: int = 0, drop_last: bool = None, process_index: int = 0,
                 process_count: int = 1, workers: int = 0, batch_transform=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = dataset.training if drop_last is None else drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.workers = workers
        # post-collate host transform (e.g. data/host_precompute.HostPrecompute
        # adding sorted points + AS rulebooks); runs on the prefetch thread so
        # it overlaps device compute like the rest of the host pipeline
        self.batch_transform = batch_transform

    def set_epoch(self, epoch):
        self.epoch = epoch

    def set_start_iter(self, n: int):
        """Skip the first n batches of the NEXT epoch only (mid-epoch
        resume; reference train_one_epoch continues at accumulated_iter).
        Index-level skip: skipped samples are never built/collated."""
        self._start_iter = int(n)

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # per-process slice (DistributedSampler equivalent)
        idx = idx[self.process_index::self.process_count]
        return idx

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _iter_serial(self):
        idx = self._indices()
        nb = len(self)
        for b in range(self._consume_start_iter(), nb):
            chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
            if len(chunk) < self.batch_size and not self.drop_last:
                # pad by wrapping (fixed batch shape for one compiled program)
                chunk = np.concatenate([chunk, idx[: self.batch_size - len(chunk)]])
            samples = [self.dataset[int(i)] for i in chunk]
            batch = self.dataset.collate(samples)
            host = batch.pop("_host", None)
            yield batch, host

    def _iter_workers(self):
        import torch.utils.data as tud

        ds = self.dataset

        class _Wrap(tud.Dataset):
            def __len__(self):
                return len(ds)

            def __getitem__(self, i):
                return ds[int(i)]

        idx = self._indices()
        nb = len(self)
        if self.drop_last:
            idx = idx[: nb * self.batch_size]
        elif len(idx) < nb * self.batch_size:
            idx = np.concatenate([idx, idx[: nb * self.batch_size - len(idx)]])
        idx = idx[self._consume_start_iter() * self.batch_size:]

        loader = tud.DataLoader(
            _Wrap(), batch_size=self.batch_size, sampler=idx.tolist(),
            num_workers=self.workers, collate_fn=ds.collate,
            persistent_workers=False, drop_last=False,
        )
        for batch in loader:
            host = batch.pop("_host", None)
            yield batch, host

    def _consume_start_iter(self) -> int:
        n = getattr(self, "_start_iter", 0)
        self._start_iter = 0
        return min(n, len(self))

    def _iter_base(self):
        it = self._iter_workers() if self.workers > 0 else self._iter_serial()
        if self.batch_transform is None:
            yield from it
        else:
            for batch, host in it:
                yield self.batch_transform(batch), host

    def __iter__(self):
        """Prefetch one batch ahead on a background thread so host-side
        augmentation/collation overlaps device compute (the reference gets
        this from torch DataLoader worker prefetching)."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=2)
        sentinel = object()
        err = []

        def producer():
            try:
                for item in self._iter_base():
                    q.put(item)
            except Exception as e:  # surface worker errors on the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]


def build_dataloader(
    dataset_cfg, class_names, batch_size, dist=False, root_path=None, workers=0,
    logger=None, training=True, seed=0, total_epochs=0, merge_all_iters_to_one_epoch=False,
    process_index=0, process_count=1, model_cfg=None,
):
    cls = DATASETS[dataset_cfg["DATASET"]]
    dataset = cls(
        dataset_cfg=dataset_cfg, class_names=class_names, training=training,
        root_path=root_path, logger=logger,
    )
    if merge_all_iters_to_one_epoch:
        dataset.merge_all_iters_to_one_epoch(True, total_epochs)
    transform = None
    if model_cfg is not None:
        # host precompute (sorted points, pillar tables, AS rulebooks) needs
        # the MODEL's backbone formulation/capacities — a no-op otherwise
        from .host_precompute import HostPrecompute

        hp = HostPrecompute(
            model_cfg, tuple(int(x) for x in dataset.grid_size[:2]),
            tuple(float(x) for x in dataset.voxel_size),
            tuple(float(x) for x in dataset.point_cloud_range),
        )
        if hp.lidar_cap is not None or hp.radar_cap is not None:
            transform = hp
    loader = DataLoader(
        dataset, batch_size, shuffle=training, seed=seed,
        process_index=process_index, process_count=process_count, workers=workers,
        batch_transform=transform,
    )
    return dataset, loader
