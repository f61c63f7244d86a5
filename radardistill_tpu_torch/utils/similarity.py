"""BEV feature similarity analytics (cosine / linear CKA / RBF CKA).

The port's own copy of ``radardistill_tpu/utils/similarity.py`` (numpy on
the host; the model's outputs come off the device once a batch). Reference:
tools/test.py:31-349 ``BEVSimilarityEngine``: a research pass that pools a
BEV feature vector per GT box (the centre pixel, or the mean or max over the
rotated box's footprint), computes pairwise instance similarities and
accumulates them into a class x class matrix over the eval set. Footprints
come from a half-plane test of the rotated rectangle broadcast over the pixel
grid, and all-pairs similarities are single matrix expressions. Two
deliberate departures from the reference, both repairs kept from the JAX
package: debiased CKA only where a feature matrix has more than one row (the
reference divides by n·(n-1) = 0), and an epsilon floor on the RBF sigma (the
reference's median sigma is 0 for one-row inputs, giving NaN grams).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array -> a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# geometry helpers (vectorized)
# ---------------------------------------------------------------------------


def world_to_bev_rc(x, y, pc_range, bev_h, bev_w):
    """World xy -> (row, col) pixel coords (tools/test.py:31-38)."""
    u = (np.asarray(x) - pc_range[0]) / (pc_range[3] - pc_range[0] + 1e-12)
    v = (np.asarray(y) - pc_range[1]) / (pc_range[4] - pc_range[1] + 1e-12)
    col = np.clip(u * bev_w, 0, bev_w - 1)
    row = np.clip(v * bev_h, 0, bev_h - 1)
    return row, col


def box_pixel_masks(boxes, pc_range, H, W):
    """(N, 7+) boxes -> (N, H, W) bool footprint masks.

    A pixel is inside when its world-space center satisfies the rotated-rect
    half-plane test |R^T (p - c)| <= extent/2 (replaces the reference's
    matplotlib polygon containment, test.py:47-59)."""
    boxes = np.asarray(boxes, np.float64)
    sx = (pc_range[3] - pc_range[0]) / W
    sy = (pc_range[4] - pc_range[1]) / H
    px = pc_range[0] + (np.arange(W) + 0.5) * sx        # (W,)
    py = pc_range[1] + (np.arange(H) + 0.5) * sy        # (H,)
    gx = px[None, None, :]                               # (1, 1, W)
    gy = py[None, :, None]                               # (1, H, 1)

    cx = boxes[:, 0, None, None]
    cy = boxes[:, 1, None, None]
    c = np.cos(boxes[:, 6])[:, None, None]
    s = np.sin(boxes[:, 6])[:, None, None]
    lx = (gx - cx) * c + (gy - cy) * s                   # (N, H, W)
    ly = -(gx - cx) * s + (gy - cy) * c
    return (np.abs(lx) <= boxes[:, 3, None, None] / 2) & (
        np.abs(ly) <= boxes[:, 4, None, None] / 2
    )


def extract_box_features(bev_hwc, boxes, pc_range, pooling="center"):
    """Per-box pooled feature vectors: (N, C).

    pooling: 'center' = feature at the box-center pixel; 'avg'/'max' pool
    over the rotated footprint, falling back to the center pixel for boxes
    whose footprint covers no pixel center (test.py:127-156)."""
    bev = np.asarray(bev_hwc)
    H, W, C = bev.shape
    boxes = np.asarray(boxes)
    row, col = world_to_bev_rc(boxes[:, 0], boxes[:, 1], pc_range, H, W)
    r = np.clip(np.round(row).astype(int), 0, H - 1)
    cc = np.clip(np.round(col).astype(int), 0, W - 1)
    center_feats = bev[r, cc]                            # (N, C)
    if pooling == "center":
        return center_feats

    masks = box_pixel_masks(boxes, pc_range, H, W)       # (N, H, W)
    m = masks[..., None]
    cnt = masks.sum(axis=(1, 2))                          # (N,)
    if pooling == "avg":
        pooled = (bev[None] * m).sum(axis=(1, 2)) / np.maximum(cnt, 1)[:, None]
    elif pooling == "max":
        pooled = np.where(m, bev[None], -np.inf).max(axis=(1, 2))
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    return np.where(cnt[:, None] > 0, pooled, center_feats)


# ---------------------------------------------------------------------------
# similarity measures
# ---------------------------------------------------------------------------


def cosine_matrix(feats):
    """(N, C) -> (N, N) pairwise cosine similarity."""
    f = np.asarray(feats, np.float64)
    f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    return f @ f.T


def cka_linear(x, y, debiased=False):
    """Linear CKA between (n, d) representations (test.py:71-86)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.shape[0]
    xty = float(np.dot(x.ravel(), y.ravel()))
    xtx = float(np.dot(x.ravel(), x.ravel()))
    yty = float(np.dot(y.ravel(), y.ravel()))
    if debiased and n > 1:
        ssx = np.sum(x * x, axis=1)
        ssy = np.sum(y * y, axis=1)

        def _deb(dot, ra, rb, na, nb):
            return (2 * dot - na * np.sum(rb) - np.sum(ra) * nb) / (n * (n - 1))

        xty = _deb(xty, ssx, ssy, np.sum(ssx), np.sum(ssy))
        xtx = _deb(xtx, ssx, ssx, np.sum(ssx), np.sum(ssx))
        yty = _deb(yty, ssy, ssy, np.sum(ssy), np.sum(ssy))
    denom = np.sqrt(max(xtx * yty, 1e-24))
    return xty / denom


def cka_rbf(x, y, debiased=False, sigma=None):
    """RBF-kernel CKA (test.py:88-96) with an epsilon-floored sigma."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)

    def sqdist(a):
        n2 = np.sum(a * a, axis=1)
        return np.maximum(n2[:, None] + n2[None, :] - 2 * a @ a.T, 0.0)

    dx, dy = sqdist(x), sqdist(y)
    if sigma is None:
        sigma = np.sqrt(0.5 * (np.median(dx) + np.median(dy)))
    sigma = max(float(sigma), 1e-6)
    gx = np.exp(-dx / (2 * sigma**2))
    gy = np.exp(-dy / (2 * sigma**2))
    return cka_linear(gx, gy, debiased)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class BEVSimilarityEngine:
    """Accumulates class×class BEV-feature similarity over an eval run.

    feature_key_path: dotted path into the model's output dict (e.g.
    'spatial_features_2d' or 'radar_spatial_features_2d'). Feed every batch
    via process_batch(out, batch); read summary() / save(dir) at the end
    (test.py:99-349 process_batch/_accumulate_class_sim/finalize)."""

    def __init__(self, feature_name: str, feature_key_path: str,
                 class_names: Sequence[str], pc_range, pooling: str = "center"):
        self.feature_name = feature_name
        self.feature_key_path = feature_key_path.split(".")
        self.class_names = list(class_names)
        self.pc_range = pc_range
        self.pooling = pooling
        n = len(class_names)
        self.cos_sums = np.zeros((n, n))
        self.cka_linear_sums = np.zeros((n, n))
        self.cka_rbf_sums = np.zeros((n, n))
        self.counts = np.zeros((n, n))

    def _features(self, out):
        x = out
        for k in self.feature_key_path:
            if not isinstance(x, dict) or k not in x:
                return None
            x = x[k]
        return _host(x)

    def process_batch(self, out: Dict, batch: Dict):
        """``out`` and ``batch`` may hold tensors on any device or arrays."""
        bev = self._features(out)
        gt = batch.get("gt_boxes")
        if bev is None or gt is None:
            return
        gt = _host(gt)
        for i in range(bev.shape[0]):
            boxes = gt[i]
            boxes = boxes[boxes[:, -1] > 0]
            if len(boxes) < 2:
                continue
            feats = extract_box_features(bev[i], boxes, self.pc_range, self.pooling)
            labels0 = boxes[:, -1].astype(int) - 1
            self._accumulate(feats, labels0)

    def _accumulate(self, feats, labels0):
        n = len(feats)
        s_cos = cosine_matrix(feats)
        # pairwise 1-row CKA: linear reduces to cosine; rbf on the 1x1 grams
        s_lin = np.empty((n, n))
        s_rbf = np.empty((n, n))
        for i in range(n):
            for j in range(i, n):
                if i == j:
                    s_lin[i, j] = s_rbf[i, j] = 1.0
                    continue
                fi, fj = feats[i : i + 1], feats[j : j + 1]
                s_lin[i, j] = s_lin[j, i] = cka_linear(fi, fj)
                s_rbf[i, j] = s_rbf[j, i] = cka_rbf(fi, fj)
        nc = len(self.class_names)
        ok = (labels0 >= 0) & (labels0 < nc)
        for i in np.nonzero(ok)[0]:
            ci = labels0[i]
            for j in np.nonzero(ok)[0]:
                if i == j:
                    continue
                cj = labels0[j]
                self.cos_sums[ci, cj] += s_cos[i, j]
                self.cka_linear_sums[ci, cj] += s_lin[i, j]
                self.cka_rbf_sums[ci, cj] += s_rbf[i, j]
                self.counts[ci, cj] += 1

    def summary(self) -> Dict[str, np.ndarray]:
        d = np.maximum(self.counts, 1)
        return {
            "cosine": self.cos_sums / d,
            "cka_linear": self.cka_linear_sums / d,
            "cka_rbf": self.cka_rbf_sums / d,
            "counts": self.counts.copy(),
        }

    def save(self, result_dir):
        """Write class×class mean-similarity CSVs (test.py finalize)."""
        import os

        out_dir = os.path.join(str(result_dir), "similarity", self.feature_name)
        os.makedirs(out_dir, exist_ok=True)
        summ = self.summary()
        header = "," + ",".join(self.class_names)
        for key in ("cosine", "cka_linear", "cka_rbf", "counts"):
            rows = [header] + [
                self.class_names[i] + ","
                + ",".join(f"{v:.6f}" for v in summ[key][i])
                for i in range(len(self.class_names))
            ]
            with open(os.path.join(out_dir, f"{key}.csv"), "w") as f:
                f.write("\n".join(rows) + "\n")
        return out_dir
