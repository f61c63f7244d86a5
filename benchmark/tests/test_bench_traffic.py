"""The traffic of a run is a function of its seed alone, and every seed
serves the same sizes in another order."""

import numpy as np
import pytest

from benchmark.lib import spec
from benchmark.lib.traffic import host_batches, scene_sizes
from small import small_cell

SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 32 + 3)


@pytest.mark.parametrize("cell", ["distill_train.bs8", "radar_serve.bs1", "radar_eval.bs4"])
def test_sizes_are_the_same_set_for_every_seed_within_the_ranges(cell):
    t = spec.load_cell(cell).traffic
    sets = []
    for seed in SEEDS:
        sizes = scene_sizes(t, seed)
        assert len(sizes) == t["batch_size"] * t["ring_batches"]
        for key, rng in (("num_radar", "radar_returns"), ("num_boxes", "boxes"),
                         ("num_lidar", "lidar_points")):
            if rng in t:
                vals = [s[key] for s in sizes]
                assert min(vals) >= t[rng][0] and max(vals) <= t[rng][1]
        sets.append(sorted((s["num_radar"], s["num_boxes"]) for s in sizes))
    assert all(sorted(x[0] for x in s) == sorted(x[0] for x in sets[0]) for s in sets)
    assert scene_sizes(t, 1) != scene_sizes(t, 2)  # another order


@pytest.mark.parametrize("cell", ["distill_train.bs8", "radar_serve.bs1"])
def test_batches_are_deterministic_for_a_seed(cell):
    c = small_cell(spec.load_cell(cell))
    a, b = (host_batches(c.traffic, c.config, 2 ** 31 + 5) for _ in range(2))
    other = host_batches(c.traffic, c.config, 2 ** 31 + 6)
    assert len(a) == c.traffic["ring_batches"]
    for x, y, z in zip(a, b, other):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x["radar_points"], z["radar_points"])
    key = "points" if "lidar_points" in c.traffic else "radar_points"
    n_points = a[0][f"{key}_mask"].sum(1)
    assert (n_points > 0).all()
