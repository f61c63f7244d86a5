// Host-side native ops for the data pipeline (dataloader workers).
//
// Native counterpart of the reference's CPU geometry kernels
// (pcdet/ops/iou3d_nms/src/iou3d_cpu.cpp — rotated BEV IoU used by the GT
// sampler's collision test, and pcdet/ops/roiaware_pool3d — points-in-box
// membership used by offline GT-database creation). They run on the host
// inside dataloader workers. Box layout: [x, y, z, dx, dy, dz, heading].
// The port's copy of radardistill_tpu/csrc/host_ops.cpp (same functions,
// same results; tests/test_torch_host.py holds the two equal).
//
// Build: data/host_ops.py compiles this file with g++ -O3 -shared -fPIC at
// first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// 4 BEV corners, CCW
void box_corners(const float* b, Pt* c) {
  const double cx = b[0], cy = b[1], dx = b[3], dy = b[4], a = b[6];
  const double ca = std::cos(a), sa = std::sin(a);
  const double lx[4] = {0.5, 0.5, -0.5, -0.5};
  const double ly[4] = {-0.5, 0.5, 0.5, -0.5};
  for (int i = 0; i < 4; ++i) {
    const double px = lx[i] * dx, py = ly[i] * dy;
    c[i].x = px * ca - py * sa + cx;
    c[i].y = px * sa + py * ca + cy;
  }
}

// Sutherland–Hodgman: clip polygon (poly, n) by half-plane left of p0->p1
int clip_halfplane(const Pt* poly, int n, Pt p0, Pt p1, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = poly[i];
    const Pt& nxt = poly[(i + 1) % n];
    const double dc = cross(p0, p1, cur);
    const double dn = cross(p0, p1, nxt);
    if (dc >= 0) out[m++] = cur;
    if ((dc >= 0) != (dn >= 0)) {
      const double t = dc / (dc - dn);
      out[m++] = {cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)};
    }
  }
  return m;
}

double polygon_area(const Pt* p, int n) {
  if (n < 3) return 0.0;
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    a += u.x * v.y - v.x * u.y;
  }
  return std::fabs(a) * 0.5;
}

double rotated_overlap(const float* ba, const float* bb) {
  Pt ca[4], cb[4];
  box_corners(ba, ca);
  box_corners(bb, cb);
  Pt buf1[16], buf2[16];
  std::memcpy(buf1, ca, sizeof(ca));
  int n = 4;
  Pt* src = buf1;
  Pt* dst = buf2;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_halfplane(src, n, cb[e], cb[(e + 1) % 4], dst);
    std::swap(src, dst);
  }
  return polygon_area(src, n);
}

}  // namespace

extern "C" {

// (N,7) x (M,7) -> (N,M) rotated BEV IoU
void boxes_iou_bev(const float* boxes_a, int n, const float* boxes_b, int m,
                   float* out) {
  for (int i = 0; i < n; ++i) {
    const float* ba = boxes_a + i * 7;
    const double area_a = (double)ba[3] * ba[4];
    for (int j = 0; j < m; ++j) {
      const float* bb = boxes_b + j * 7;
      const double inter = rotated_overlap(ba, bb);
      const double uni = area_a + (double)bb[3] * bb[4] - inter;
      out[i * m + j] = (float)(inter / std::max(uni, 1e-6));
    }
  }
}

// (N,7) x (M,7) -> (N,M) 3D IoU
void boxes_iou_3d(const float* boxes_a, int n, const float* boxes_b, int m,
                  float* out) {
  for (int i = 0; i < n; ++i) {
    const float* ba = boxes_a + i * 7;
    const double va = (double)ba[3] * ba[4] * ba[5];
    for (int j = 0; j < m; ++j) {
      const float* bb = boxes_b + j * 7;
      const double inter_bev = rotated_overlap(ba, bb);
      const double hi = std::min(ba[2] + ba[5] / 2.0, bb[2] + bb[5] / 2.0);
      const double lo = std::max(ba[2] - ba[5] / 2.0, bb[2] - bb[5] / 2.0);
      const double ih = std::max(hi - lo, 0.0);
      const double inter = inter_bev * ih;
      const double vb = (double)bb[3] * bb[4] * bb[5];
      out[i * m + j] = (float)(inter / std::max(va + vb - inter, 1e-6));
    }
  }
}

// (N,3) points x (M,7) boxes -> (N,) int32 index of first containing box, -1 if none
void points_in_boxes(const float* pts, int n, const float* boxes, int m,
                     int32_t* out) {
  for (int i = 0; i < n; ++i) {
    const float px = pts[i * 3], py = pts[i * 3 + 1], pz = pts[i * 3 + 2];
    out[i] = -1;
    for (int j = 0; j < m; ++j) {
      const float* b = boxes + j * 7;
      const float dz = pz - b[2];
      if (std::fabs(dz) >= b[5] / 2) continue;
      const float sx = px - b[0], sy = py - b[1];
      const float ca = std::cos(-b[6]), sa = std::sin(-b[6]);
      const float lx = sx * ca - sy * sa;
      const float ly = sx * sa + sy * ca;
      if (std::fabs(lx) < b[3] / 2 && std::fabs(ly) < b[4] / 2) {
        out[i] = j;
        break;
      }
    }
  }
}

// Greedy rotated NMS on host: returns number kept; keep indices in `keep`.
int nms_bev(const float* boxes, const float* scores, int n, float thresh,
            int32_t* keep) {
  // order by score desc (stable)
  int32_t* order = new int32_t[n];
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order, order + n,
                   [&](int a, int b) { return scores[a] > scores[b]; });
  bool* suppressed = new bool[n]();
  int nk = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep[nk++] = i;
    const float* bi = boxes + i * 7;
    const double area_i = (double)bi[3] * bi[4];
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + j * 7;
      const double inter = rotated_overlap(bi, bj);
      const double uni = area_i + (double)bj[3] * bj[4] - inter;
      if (inter / std::max(uni, 1e-6) > thresh) suppressed[j] = true;
    }
  }
  delete[] order;
  delete[] suppressed;
  return nk;
}

// ---------------------------------------------------------------------------
// Active-site sparse-conv index tables (host-side rulebook construction).
//
// The equivalent of spconv's host-built gather/scatter rulebooks (the
// reference consumes them via pcdet/utils/spconv_utils.py:1-38; spconv caches
// them per indice-key on first sight of a geometry). The tables are pure
// functions of the point COORDS, so the dataloader builds them here and
// ships them as batch inputs. Semantics are BIT-IDENTICAL to the JAX
// package's device build (radardistill_tpu/ops/active_site.py
// conv_neighbor_table_b / invert_taps_b / downsample_active).

// Neighbor + inverse tables for one 3x3 pad-1 conv (stride 1 = subm, 2 =
// down). Mirrors active_site.conv_neighbor_table_b + invert_taps_b:
//   nb  (9, cap_out) input rows, hole-filled monotone per tap, clipped;
//   msk (9, cap_out) 1 where the neighbor exists;
//   inv (9, cap_in)  output rows (tap-inverse permutation), filled+clipped;
//   imsk(9, cap_in)  1 where input row is referenced by the tap.
void as_build_tap(const int32_t* out_uids, int cap_out,
                  const int32_t* in_uids, int cap_in,
                  int h_in, int w_in, int out_w, int stride,
                  int32_t* nb, uint8_t* msk, int32_t* inv, uint8_t* imsk) {
  const int hw = h_in * w_in;
  const int h_out = h_in / stride;
  // dense site-index grid of the input set (site_index_grid equivalent)
  std::vector<int32_t> grid(hw, cap_in);
  for (int r = 0; r < cap_in; ++r) {
    const int32_t u = in_uids[r];
    if (u >= 0 && u < hw) grid[u] = r;
  }
  for (int k = 0; k < 9; ++k) {
    const int ky = k / 3, kx = k % 3;
    int32_t run = -1;  // cummax hole fill
    int32_t* nbk = nb + k * cap_out;
    uint8_t* mk = msk + k * cap_out;
    int32_t* ivk = inv + k * cap_in;
    uint8_t* imk = imsk + k * cap_in;
    // inverse map scratch: min output row per input row (sentinel cap_out)
    std::vector<int32_t> tgt(cap_in, cap_out);
    for (int o = 0; o < cap_out; ++o) {
      const int32_t u = out_uids[o];
      const int oy = u / out_w, ox = u % out_w;
      const int iy = oy * stride - 1 + ky;
      const int ix = ox * stride - 1 + kx;
      const bool ok = (oy < h_out) && iy >= 0 && iy < h_in && ix >= 0 && ix < w_in;
      int32_t nbv = cap_in;
      if (ok) nbv = grid[iy * w_in + ix];
      const bool exists = ok && nbv < cap_in;
      mk[o] = exists ? 1 : 0;
      if (exists) {
        if (nbv > run) run = nbv;
        if (tgt[nbv] > o) tgt[nbv] = o;  // per-tap injective: first wins
      }
      int32_t v = run;
      if (v < 0) v = 0;
      if (v > cap_in - 1) v = cap_in - 1;
      nbk[o] = v;
    }
    int32_t irun = -1;
    for (int r = 0; r < cap_in; ++r) {
      const bool ex = tgt[r] < cap_out;
      imk[r] = ex ? 1 : 0;
      if (ex && tgt[r] > irun) irun = tgt[r];
      int32_t v = irun;
      if (v < 0) v = 0;
      if (v > cap_out - 1) v = cap_out - 1;
      ivk[r] = v;
    }
  }
}

// Pillar encode: per-point ids (f32 floor((xy-range)/voxel), sentinel nx*ny
// for masked/out-of-range), STABLE radix sort of points by id, and the
// compact-unique pillar table. One call replaces a numpy argsort +
// take_along_axis path that is too slow for a loader thread. Semantics identical
// to ops/voxelize.compute_pillar_coords + pillar_ids + stable argsort +
// active_site.compact_unique_sorted.
// points (n, f) f32 row-major; outputs: pts_s (n, f), mask_s (n) u8,
// ids_s (n) i32, slot (n) i32, uids (capacity) i32, mean_s (n, 3) f32
// (per-point cluster mean = mean xyz of the point's pillar over VALID
// points — the host twin of models/vfe._slot_mean; sentinel segment -> 0;
// double accumulation, so it differs from the device's f32 tree sum only
// at f32 rounding). Returns the true unique-pillar count (pre-capping).
int32_t pillar_sort_encode(const float* points, const uint8_t* mask, int n,
                           int f, float x0, float y0, float vx, float vy,
                           int nx, int ny, int capacity, int packed,
                           float* pts_s, uint8_t* mask_s, int32_t* ids_s,
                           int32_t* slot, int32_t* uids, float* mean_s) {
  const int32_t sent = nx * ny;
  // `packed`: sort by the space-to-depth parent-major key (id VALUES stay
  // linear) — voxelize.packed_key twin; the S2D entry densify then needs no
  // packed-index transpose on device.
  std::vector<int32_t> ids(n), keys(n);
  for (int i = 0; i < n; ++i) {
    const float px = points[(size_t)i * f];
    const float py = points[(size_t)i * f + 1];
    const int32_t cx = (int32_t)std::floor((px - x0) / vx);
    const int32_t cy = (int32_t)std::floor((py - y0) / vy);
    const bool ok = mask[i] && cx >= 0 && cx < nx && cy >= 0 && cy < ny;
    ids[i] = ok ? cy * nx + cx : sent;
    keys[i] = (ok && packed)
                  ? ((((cy >> 1) * (nx >> 1) + (cx >> 1)) << 2) +
                     ((cy & 1) << 1) + (cx & 1))
                  : ids[i];
  }
  // stable LSD radix sort of indices by key (11-bit digits; keys <= nx*ny
  // fit 3 passes up to 8G cells — far beyond any BEV grid)
  std::vector<int32_t> ord(n), tmp(n);
  for (int i = 0; i < n; ++i) ord[i] = i;
  const int BITS = 11, BUCKETS = 1 << BITS;
  int passes = 0;
  for (int64_t m = (int64_t)sent; m > 0; m >>= BITS) ++passes;
  std::vector<int32_t> cnt(BUCKETS);
  for (int p = 0; p < passes; ++p) {
    const int sh = p * BITS;
    std::fill(cnt.begin(), cnt.end(), 0);
    for (int i = 0; i < n; ++i) ++cnt[(keys[ord[i]] >> sh) & (BUCKETS - 1)];
    int32_t run = 0;
    for (int b = 0; b < BUCKETS; ++b) {
      const int32_t c = cnt[b];
      cnt[b] = run;
      run += c;
    }
    for (int i = 0; i < n; ++i) {
      const int32_t o = ord[i];
      tmp[cnt[(keys[o] >> sh) & (BUCKETS - 1)]++] = o;
    }
    std::swap(ord, tmp);
  }
  // gather payloads + compact unique (first-occurrence slots, overflow=cap)
  for (int32_t u = 0; u < capacity; ++u) uids[u] = sent;
  int32_t prev = -1, pos = -1;
  for (int i = 0; i < n; ++i) {
    const int32_t o = ord[i];
    const int32_t id = ids[o];
    std::memcpy(pts_s + (size_t)i * f, points + (size_t)o * f,
                sizeof(float) * f);
    mask_s[i] = mask[o];
    ids_s[i] = id;
    const bool valid = id < sent;
    if (valid && id != prev) {
      ++pos;
      if (pos < capacity) uids[pos] = id;
      prev = id;
    }
    slot[i] = (valid && pos < capacity) ? pos : capacity;
  }
  // per-point cluster means: one sequential pass over the sorted ids
  // (segments = runs of equal id; the sentinel run sums zero valid points
  // and clip(count, 1) makes its mean exactly 0, matching _slot_mean)
  {
    int i = 0;
    while (i < n) {
      const int32_t id = ids_s[i];
      int j = i;
      double sx = 0.0, sy = 0.0, sz = 0.0;
      int64_t cnt = 0;
      for (; j < n && ids_s[j] == id; ++j) {
        if (id < sent) {
          sx += pts_s[(size_t)j * f];
          sy += pts_s[(size_t)j * f + 1];
          sz += pts_s[(size_t)j * f + 2];
          ++cnt;
        }
      }
      const double d = cnt > 0 ? (double)cnt : 1.0;
      const float mx = (float)(sx / d), my = (float)(sy / d),
                  mz = (float)(sz / d);
      for (int k = i; k < j; ++k) {
        mean_s[(size_t)k * 3] = mx;
        mean_s[(size_t)k * 3 + 1] = my;
        mean_s[(size_t)k * 3 + 2] = mz;
      }
      i = j;
    }
  }
  return pos + 1;
}

// Output active set of a 3x3 stride-2 pad-1 SparseConv2d (active_site.
// downsample_active equivalent: out site active iff its receptive field
// touches an active input; overflow drops LARGEST ids). Returns the true
// active count (pre-capping) for overflow accounting.
int32_t as_downsample(const int32_t* uids, int cap, int h, int w, int cap_out,
                      int32_t* out_uids) {
  const int h2 = h / 2, w2 = w / 2;
  const int hw = h * w;
  std::vector<uint8_t> act((size_t)h2 * w2, 0);
  for (int r = 0; r < cap; ++r) {
    const int32_t u = uids[r];
    if (u >= hw || u < 0) continue;
    const int y = u / w, x = u % w;
    const int oy0 = y / 2, oy1 = (y + 1) / 2;
    const int ox0 = x / 2, ox1 = (x + 1) / 2;
    for (int oy = oy0; oy <= oy1; ++oy) {
      if (oy >= h2) continue;
      for (int ox = ox0; ox <= ox1; ++ox) {
        if (ox >= w2) continue;
        act[(size_t)oy * w2 + ox] = 1;
      }
    }
  }
  int32_t n = 0;
  const int32_t sent = h2 * w2;
  for (int32_t c = 0; c < sent; ++c) {
    if (!act[c]) continue;
    if (n < cap_out) out_uids[n] = c;
    ++n;
  }
  for (int32_t i = n < cap_out ? n : cap_out; i < cap_out; ++i)
    out_uids[i] = sent;
  return n;
}

}  // extern "C"
