// The decode's class-agnostic rotated NMS as two kernels: the BEV-IoU overlap
// bitmask of every (problem, rank, rank) pair, then the greedy scan of each
// problem's ranks (ops/nms.py::class_agnostic_nms_batched).
//
// Replaces no Pallas kernel: the JAX package leaves NMS to XLA
// (radardistill_tpu/ops/nms.py::class_agnostic_nms, a while_loop fixed point
// over the dense IoU matrix). The port's plain route does the same with one
// host synchronization a round and some 160 eager clipping launches a problem;
// these kernels compute the same keep set with no host round trip.
//
// What bounds it on the H100: operations. At the decode's shapes (P = 6 or 24
// problems of K = 500 candidates) the upper triangle holds 125 k pairs a
// problem, each a Sutherland-Hodgman clip of one quad by another's four
// half-planes (a few hundred float32 operations outside the tensor cores),
// while the bytes are the corners, areas and validity in and a K x K/64-word
// mask out: some tens of microseconds of float32 work against one of memory.
// The mask kernel gives each 64 x 64 tile of (rank, rank) pairs above the
// diagonal to one CTA, the 64 column boxes staged in shared memory, each row
// box's four edges in registers of 8 threads that take an eighth of the
// columns each (with one thread a row, 6 problems filled 3 warps an SM and
// the latency of each thread's 64 serial clips set the time); a ring that
// clips to nothing ends the pair early (most pairs are far apart). Tiles
// below the diagonal only write zero words, so the whole mask is defined.
//
// Bit b of mask[p][i][w] is set when candidate j = 64 w + b is ranked below i
// (j > i) and both are valid and the IoU of j's ring clipped by i's
// half-planes is above the threshold: boxes_iou_bev(cand, cand)[j, i] of the
// plain route, the entry its suppression reads. Each pair repeats the plain
// route's steps: the 8-slot ring, the wrap of the last vertex to the first,
// the 1e-12 guard of the denominator, the compaction cut at 8 vertices, the
// area (its 8 cross products summed in the order of PyTorch's CUDA sum over
// an 8-wide row) only where 3 or more vertices are left, and
// inter / max(area_j + area_i - inter, 1e-6) > thresh. Every product, sum and
// quotient is an __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn: nvcc contracts
// a * b + c into one FMA by default, which rounds once where PyTorch's eager
// ops round twice, and could move an IoU across the threshold and so change
// the keep set. The library's flags are global and the conv kernels want FMA,
// so the intrinsics, which are never contracted, do this job here.
//
// The scan is greedy NMS: walk the ranks in order, keep a valid candidate not
// yet removed and remove what its mask row marks. Each step depends on all
// earlier ones, so a problem is one warp and the problems run side by side
// (one warp a CTA, spread over the SMs): a larger group would only wait. The
// warp keeps the removed words in shared memory, holds the 64 diagonal words
// of a block of ranks in registers (two a lane) and resolves the block with
// shuffles, then ORs the kept rows' words further right in with a warp
// reduction. Greedy NMS is the unique fixed point of the plain route's
// recursion, so the keep set is the same set. The output is that route's:
// the kept candidates in rank order, then the others in rank order, the first
// M of them as indices into the problem's unsorted candidates (order[rank]).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // ranks a tile side, and bits a mask word
constexpr int kGroups = 8;  // column groups a tile: 512 threads a CTA
constexpr int kVerts = 8;  // a quad clipped by 4 half-planes has at most 8
constexpr unsigned kFull = 0xffffffffu;

// Area of the subject quad (x0, y0, ..., x3, y3, counter-clockwise) clipped
// by the clipper's four directed edges (p, p + e), as the plain route
// computes it (ops/geometry.py::_intersection_area_batched).
__device__ float clipped_area(const float* subject, const float* px, const float* py,
                              const float* ex, const float* ey) {
  float vx[kVerts], vy[kVerts], ox[kVerts], oy[kVerts], d[kVerts];
  int n = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    vx[k] = subject[2 * k];
    vy[k] = subject[2 * k + 1];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    for (int k = 0; k < n; ++k)
      d[k] = __fsub_rn(__fmul_rn(ex[e], __fsub_rn(vy[k], py[e])),
                       __fmul_rn(ey[e], __fsub_rn(vx[k], px[e])));
    int cnt = 0;
    for (int k = 0; k < n; ++k) {
      const int nk = k == n - 1 ? 0 : k + 1;
      const bool inside = d[k] >= 0.f, next_inside = d[nk] >= 0.f;
      if (inside) {
        if (cnt < kVerts) {
          ox[cnt] = vx[k];
          oy[cnt] = vy[k];
        }
        ++cnt;
      }
      if (inside != next_inside) {
        const float den = __fsub_rn(d[k], d[nk]);
        const float t = __fdiv_rn(d[k], fabsf(den) < 1e-12f ? 1e-12f : den);
        if (cnt < kVerts) {
          ox[cnt] = __fadd_rn(vx[k], __fmul_rn(t, __fsub_rn(vx[nk], vx[k])));
          oy[cnt] = __fadd_rn(vy[k], __fmul_rn(t, __fsub_rn(vy[nk], vy[k])));
        }
        ++cnt;
      }
    }
    n = cnt < kVerts ? cnt : kVerts;
    if (n == 0) return 0.f;  // an empty ring stays empty
    for (int k = 0; k < n; ++k) {
      vx[k] = ox[k];
      vy[k] = oy[k];
    }
  }
  if (n < 3) return 0.f;
  float c[kVerts];
#pragma unroll
  for (int k = 0; k < kVerts; ++k) {
    c[k] = 0.f;
    if (k < n) {
      const int nk = k == n - 1 ? 0 : k + 1;
      c[k] = __fsub_rn(__fmul_rn(vx[k], vy[nk]), __fmul_rn(vx[nk], vy[k]));
    }
  }
  // PyTorch's CUDA sum of an 8-wide row: lane k holds c[k] and each step
  // adds the lane 4, 2, then 1 above
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(c[0], c[4]), __fadd_rn(c[2], c[6])),
                            __fadd_rn(__fadd_rn(c[1], c[5]), __fadd_rn(c[3], c[7])));
  return __fmul_rn(0.5f, fabsf(s));
}

// grid (T, T, P), T = ceil(K / 64): CTA (cb, rb, p) writes mask[p][i][cb] for
// the 64 rows i of block rb. Thread (g, r) of the CTA takes row r and the
// columns g, g + 8, ... of the tile; a warp is 32 rows of one column group,
// so its lanes read the same column box at each step.
__global__ void __launch_bounds__(kTile * kGroups)
nms_bev_mask_kernel(const float* __restrict__ corners, const float* __restrict__ areas,
                    const uint8_t* __restrict__ valid, int K, int W, float thresh,
                    unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, t = threadIdx.x;
  const int r = t % kTile, g = t / kTile;
  const int64_t base = (int64_t)blockIdx.z * K;
  const int i = rb * kTile + r;
  unsigned long long* out = mask + (base + i) * W + cb;
  if (cb < rb) {  // every such j ranks above i
    if (g == 0 && i < K) *out = 0ull;
    return;
  }
  __shared__ float s_corners[kTile * kVerts];
  __shared__ float s_area[kTile];
  __shared__ uint8_t s_valid[kTile];
  __shared__ unsigned long long s_bits[kGroups][kTile];
  const int j0 = cb * kTile;
  const int n_col = K - j0 < kTile ? K - j0 : kTile;
  if (t < n_col * kVerts) s_corners[t] = corners[(base + j0) * kVerts + t];
  if (t < n_col) {
    s_area[t] = areas[base + j0 + t];
    s_valid[t] = valid[base + j0 + t];
  }
  __syncthreads();
  unsigned long long bits = 0ull;
  if (i < K && valid[base + i]) {
    float px[4], py[4], ex[4], ey[4];
    const float* ci = corners + (base + i) * kVerts;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = (e + 1) & 3;
      px[e] = ci[2 * e];
      py[e] = ci[2 * e + 1];
      ex[e] = __fsub_rn(ci[2 * f], px[e]);
      ey[e] = __fsub_rn(ci[2 * f + 1], py[e]);
    }
    const float area_i = areas[base + i];
    for (int jj = g; jj < n_col; jj += kGroups) {
      if ((cb == rb && jj <= r) || !s_valid[jj]) continue;
      const float inter = clipped_area(s_corners + jj * kVerts, px, py, ex, ey);
      const float uni = __fsub_rn(__fadd_rn(s_area[jj], area_i), inter);
      // clamp(min=1e-6) keeps a NaN, as PyTorch's does
      const float iou = __fdiv_rn(inter, uni < 1e-6f ? 1e-6f : uni);
      if (iou > thresh) bits |= 1ull << jj;
    }
  }
  s_bits[g][r] = bits;
  __syncthreads();
  if (g == 0 && i < K) {
#pragma unroll
    for (int h = 1; h < kGroups; ++h) bits |= s_bits[h][r];
    *out = bits;
  }
}

// one warp a problem; dynamic shared memory: removed[W], then kept[W]
__global__ void __launch_bounds__(32)
nms_bev_scan_kernel(const unsigned long long* __restrict__ mask,
                    const uint8_t* __restrict__ valid, const int64_t* __restrict__ order,
                    int K, int W, int M, int64_t* __restrict__ sel,
                    uint8_t* __restrict__ sel_valid) {
  extern __shared__ unsigned long long words[];
  unsigned long long* removed = words;
  unsigned long long* kept = words + W;
  const int64_t p = blockIdx.x;
  const int lane = threadIdx.x;
  mask += p * K * W;
  valid += p * K;
  order += p * K;
  sel += p * M;
  sel_valid += p * M;

  // an invalid candidate starts removed, and so do the slots past K
  for (int w = 0; w < W; ++w) {
    const int j0 = kTile * w + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(kFull, j0 < K && valid[j0]);
    const unsigned hi = __ballot_sync(kFull, j1 < K && valid[j1]);
    if (lane == 0) removed[w] = ~((unsigned long long)hi << 32 | lo);
  }
  __syncwarp();
  for (int w = 0; w < W; ++w) {
    const int i0 = kTile * w + lane, i1 = i0 + 32;
    const unsigned long long d0 = i0 < K ? mask[(int64_t)i0 * W + w] : 0ull;
    const unsigned long long d1 = i1 < K ? mask[(int64_t)i1 * W + w] : 0ull;
    unsigned long long cur = removed[w], keep = 0ull;
    for (int b = 0; b < kTile; ++b) {  // cur and keep are the same in every lane
      const unsigned long long row = __shfl_sync(kFull, b < 32 ? d0 : d1, b & 31);
      if (!(cur >> b & 1ull)) {
        keep |= 1ull << b;
        cur |= row;
      }
    }
    const bool k0 = keep >> lane & 1ull, k1 = keep >> (lane + 32) & 1ull;
#pragma unroll 4
    for (int w2 = w + 1; w2 < W; ++w2) {
      unsigned long long v = (k0 ? mask[(int64_t)i0 * W + w2] : 0ull) |
                             (k1 ? mask[(int64_t)i1 * W + w2] : 0ull);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v |= __shfl_xor_sync(kFull, v, off);
      if (lane == 0) removed[w2] |= v;
    }
    if (lane == 0) kept[w] = keep;
    __syncwarp();
  }

  // kept ones first, then the rest, each in rank order; the first M written
  int n_kept = 0;
  for (int w = 0; w < W; ++w) n_kept += __popcll(kept[w]);
  int before = 0;  // kept candidates ranked before this group of 32
  for (int g = 0; g < K; g += 32) {
    const int j = g + lane;
    const bool alive = j < K && (kept[j >> 6] >> (j & 63) & 1ull);
    const unsigned ballot = __ballot_sync(kFull, alive);
    const int a = before + __popc(ballot & ((1u << lane) - 1u));
    const int pos = alive ? a : n_kept + (j - a);
    if (j < K && pos < M) {
      sel[pos] = order[j];
      sel_valid[pos] = alive;
    }
    before += __popc(ballot);
  }
}

}  // namespace

// corners (P, K, 4, 2) float32, areas (P, K) float32, valid (P, K) bool ->
// mask (P, K, ceil(K / 64)) 64-bit words; all contiguous on `device`.
extern "C" int rdt_nms_bev_mask(const float* corners, const float* areas, const uint8_t* valid,
                                int P, int K, float thresh, unsigned long long* mask,
                                int device, void* stream) {
  if (P < 0 || K < 0 || P > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (P == 0 || K == 0) return cudaGetLastError();
  const int T = (K + kTile - 1) / kTile;
  nms_bev_mask_kernel<<<dim3(T, T, P), kTile * kGroups, 0, static_cast<cudaStream_t>(stream)>>>(
      corners, areas, valid, K, T, thresh, mask);
  return cudaGetLastError();
}

// mask from rdt_nms_bev_mask, valid (P, K) bool, order (P, K) int64 ->
// sel (P, M) int64, sel_valid (P, M) bool, M <= K.
extern "C" int rdt_nms_bev_scan(const unsigned long long* mask, const uint8_t* valid,
                                const int64_t* order, int P, int K, int M, int64_t* sel,
                                uint8_t* sel_valid, int device, void* stream) {
  if (P < 0 || K < 0 || M < 0 || M > K) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (P == 0 || K == 0) return cudaGetLastError();
  const int W = (K + kTile - 1) / kTile;
  const size_t smem = 2 * (size_t)W * sizeof(unsigned long long);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  nms_bev_scan_kernel<<<P, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      mask, valid, order, K, W, M, sel, sel_valid);
  return cudaGetLastError();
}
