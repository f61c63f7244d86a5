"""The one traffic generator: collated host batches drawn from a seed.

A traffic file (``traffic/<name>.json``) gives:

- ``kind``: ``train`` (a ring of batches staged on the card at set-up and
  stepped through in turn) or ``serve`` (a ring of host frames, each call
  copies its batch to the card and reads its boxes back);
- ``batch_size`` and ``ring_batches``: the scenes of a call, and how many
  distinct calls the ring holds;
- ``lidar_points`` (absent: radar only), ``radar_returns`` and ``boxes``:
  ``[lo, hi]`` ranges of each scene's sizes;
- ``caps``: the collate's fixed capacities (``MAX_LIDAR_POINTS``,
  ``MAX_RADAR_POINTS``, ``NUM_MAX_OBJS``).

Every seed serves the same set of sizes, in another order and on other
scenes: the sizes of the ring's ``n`` scenes are the midpoints of ``n``
equal slices of each range, shuffled by the seed. So the work of a run does
not depend on its seed, and two seeds differ only in what the scenes hold.
A scene is the frozen copy of the program's ``make_scene`` below (half its
points uniform over the range, half inside its boxes).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..reference.rdt.data.collate import collate_batch


def make_scene(rng: np.random.RandomState, num_lidar, num_radar: int, num_boxes: int,
               pc_range, num_classes: int = 10, lidar_feats: int = 5, radar_feats: int = 6):
    """dict(points (N, 5) xyzit unless ``num_lidar`` is None, radar_points
    (M, 6) xyz + rcs + vxy, gt_boxes (K, 10) [x, y, z, dx, dy, dz, heading,
    vx, vy, cls])."""
    lo = np.array(pc_range[:3])
    hi = np.array(pc_range[3:])

    boxes = np.zeros((num_boxes, 10), np.float32)
    boxes[:, 0:2] = rng.uniform(lo[0] * 0.8, hi[0] * 0.8, (num_boxes, 2))
    boxes[:, 2] = rng.uniform(-2, 0.5, num_boxes)
    boxes[:, 3:5] = rng.uniform(0.5, 6.0, (num_boxes, 2))
    boxes[:, 5] = rng.uniform(0.8, 3.0, num_boxes)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, num_boxes)
    boxes[:, 7:9] = rng.uniform(-3, 3, (num_boxes, 2))
    boxes[:, 9] = rng.randint(1, num_classes + 1, num_boxes)

    def cloud(n, nf):
        pts = np.zeros((n, nf), np.float32)
        nb = n // 2  # half background, half on objects
        pts[:nb, 0:3] = rng.uniform(lo, hi, (nb, 3))
        per_box = max((n - nb) // max(num_boxes, 1), 1)
        i = nb
        for b in boxes:
            k = min(per_box, n - i)
            if k <= 0:
                break
            local = rng.uniform(-0.5, 0.5, (k, 3)) * b[3:6]
            c, s = np.cos(b[6]), np.sin(b[6])
            pts[i:i + k, 0] = local[:, 0] * c - local[:, 1] * s + b[0]
            pts[i:i + k, 1] = local[:, 0] * s + local[:, 1] * c + b[1]
            pts[i:i + k, 2] = local[:, 2] + b[2]
            i += k
        pts[:, 3:] = rng.uniform(0, 1, (n, nf - 3))
        return pts

    scene = {"radar_points": cloud(num_radar, radar_feats), "gt_boxes": boxes}
    if num_lidar is not None:
        scene["points"] = cloud(num_lidar, lidar_feats)
    return scene


def stratified(lo: int, hi: int, n: int, rng: np.random.RandomState) -> np.ndarray:
    """The midpoints of ``n`` equal slices of [lo, hi], rounded, in the order
    ``rng`` shuffles them."""
    mids = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return rng.permutation(np.round(mids).astype(np.int64))


def scene_sizes(traffic: Dict[str, Any], seed: int) -> List[Dict[str, Any]]:
    """Each scene's (lidar points, radar returns, boxes), ring order."""
    n = traffic["batch_size"] * traffic["ring_batches"]
    rng = np.random.RandomState(np.random.SeedSequence([seed, 1]).generate_state(1))
    lidar = (stratified(*traffic["lidar_points"], n, rng) if "lidar_points" in traffic
             else [None] * n)
    radar = stratified(*traffic["radar_returns"], n, rng)
    boxes = stratified(*traffic["boxes"], n, rng)
    return [{"num_lidar": None if lidar[i] is None else int(lidar[i]),
             "num_radar": int(radar[i]), "num_boxes": int(boxes[i])} for i in range(n)]


def host_batches(traffic: Dict[str, Any], config: Dict[str, Any], seed: int
                 ) -> List[Dict[str, np.ndarray]]:
    """The ring: ``ring_batches`` collated numpy batches of ``batch_size``
    scenes each, as the collate gives them (no host-precomputed tables)."""
    sizes = scene_sizes(traffic, seed)
    bs = traffic["batch_size"]
    batches = []
    for b in range(traffic["ring_batches"]):
        scenes = []
        for i in range(b * bs, (b + 1) * bs):
            rng = np.random.RandomState(np.random.SeedSequence([seed, 2, i]).generate_state(1))
            scenes.append(make_scene(rng, pc_range=config["POINT_CLOUD_RANGE"], **sizes[i]))
        batch = collate_batch(scenes, dict(traffic["caps"]))
        batch.pop("_host", None)
        batches.append(batch)
    return batches
