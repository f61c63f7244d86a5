// K4: DCNv2 backward with respect to the input: the transpose of the masked
// bilinear tap sampling of dcn_sample.cu.
//
//   dx[b, r, q, c] = sum of m_k * fh * fw * dsampled[b, ho, wo, k*C + c]
//
// over every output site (b, ho, wo), tap k and corner (r, q) of the sample at
// (ho*stride - pad + ki + dy_k, wo*stride - pad + kj + dx_k) that lies on the
// grid; offsets clamped to [-R, R] first when the caller asks for it, with the
// geometry of dcn_geom.cuh (a NaN offset stays NaN and adds nothing).
//
// Replaces the TPU kernel radardistill_tpu/ops/pallas_dcn.py (_grad_kernel,
// entered through dcn_input_grad). A TPU cannot scatter rows, so that kernel
// gave each block of 10 input rows a float32 accumulator in VMEM, built
// one-hot matrices from every sample of the window of output rows that the
// +-R clamp lets reach the block, accumulated M^T @ (mask * dsampled) and
// wrote dx once.
//
// What bounds it on the H100: bytes. The function reads dsampled (9*C values
// a site) once and writes dx once; the arithmetic is 2 operations per corner
// and channel. Two routes:
//
// "tile" (rdt_dcn_input_grad_tile; every clamped call, which is every call of
// the model): the TPU kernel's structure on this card, owner-computed tiles
// of dx. A CTA owns TH x TW cells x all C channels of one batch element and
// writes each cell once, in dsampled's dtype: no scratch in device memory,
// no zeroing or cast pass, no atomics in device memory. The clamp bounds the
// output sites whose samples can reach the tile; the host computes that
// window (ops/dcn_grad.py::reach_window) per tile row and tile column and
// passes it. Phase 1, all threads: the geometry of every (site, tap) of the
// window, every offset read once a tile and all in flight together; each
// pair whose first corner (h0, w0) lies in the tile or one row above or one
// column left goes into the bucket of that cell (counted with shared-memory
// integer atomics, placed by a prefix sum, then sorted). Phase 2: a warp
// takes two cells, 16 lanes a cell, each lane two 16-byte vectors of its
// cell's channels with float32 accumulators in registers: corner (a, bb) of
// every pair in the bucket of the cell (a, bb) up and left, m*fh*fw*ds, the
// dsampled rows read whole (512 bytes a half-warp at C 256), two in flight.
// Every (cell, channel) is summed by one lane in a fixed order (corners,
// then pairs in window order), so dx repeats bit for bit. A pair's row is
// read once for each of its corners on the grid, mostly from L2: the four
// cells are neighbours. The host picks tiles of at most 8 x 8 cells and 8
// warps (tools/torch_dcn_ab.py --sweep times other tiles at the CMA's
// sites).
//
// "atomic" (rdt_dcn_input_grad; unclamped calls, shapes outside the
// reference's clamp gate): no clamp means no window. Each sample adds to
// its four corner cells directly: one block per output site, the first 9
// threads compute the tap geometry and masked corner weights into shared
// memory, then every thread takes 4 neighbouring channels of one tap and
// issues one 16-byte vector atomic (red.global.add.v4.f32, sm_90) per corner
// into a float32 (B, H, W, C) buffer that the caller zeroes before the launch
// and casts to dsampled's dtype after it. The atomics add in an order that
// changes from run to run, so this route's dx repeats to rounding only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_geom.cuh"

namespace {

using dcn::kTaps;
using dcn::Vec16;

// ------------------------------------------------------------ route "tile"

constexpr int kCells = 2;  // the cells a warp sums together
constexpr int kBatch = 2;  // the dsampled rows a lane loads before adding them

template <typename T>
__global__ void __launch_bounds__(256)
    dcn_input_grad_tile_kernel(const T* __restrict__ dsampled,
                               const float* __restrict__ offset,
                               const float* __restrict__ mask,
                               const int* __restrict__ window,
                               T* __restrict__ dx, int H, int W, int C, int Ho,
                               int Wo, int stride, int pad, float max_offset,
                               int TH, int TW, int n_tr, int n_tc, int cap) {
  using V = Vec16<T>;
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tr = blockIdx.x / n_tc, tc = blockIdx.x % n_tc;
  const int b = blockIdx.y;
  const int r0 = tr * TH, q0 = tc * TW;
  const int rows = min(TH, H - r0), cols = min(TW, W - q0);
  // the output sites whose clamped samples can reach the tile
  const int ho0 = window[2 * tr], ho1 = window[2 * tr + 1];
  const int wo0 = window[2 * (n_tr + tc)], wo1 = window[2 * (n_tr + tc) + 1];
  const int nc = wo1 - wo0 + 1;
  const int n = ho1 >= ho0 && nc > 0 ? (ho1 - ho0 + 1) * nc * kTaps : 0;

  // Shared memory: the window's (site, tap) pairs (index into dsampled's
  // rows, dh, dw, m) and the cell of the tile's frame that holds each one's
  // first corner; then one bucket of pairs per cell of the frame, the tile
  // with one more row above and one more column left: a cell's four corners
  // come from the buckets of itself and its three upper-left neighbours.
  const int E = (TH + 1) * (TW + 1);
  extern __shared__ int4 smem[];
  int4* geo = smem;
  int* home = reinterpret_cast<int*>(geo + cap);
  int* bucket = home + cap;
  int* count = bucket + cap;
  int* start = count + E;
  int* cursor = start + E;

  for (int e = threadIdx.x; e < E; e += blockDim.x) count[e] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = i % kTaps, s = i / kTaps;
    const int ho = ho0 + s / nc, wo = wo0 + s % nc;
    const int pair = ((b * Ho + ho) * Wo + wo) * kTaps + k;
    const float2 off = *reinterpret_cast<const float2*>(offset + 2 * (int64_t)pair);
    const dcn::Tap t = dcn::tap_of(off.x, off.y, ho, wo, k, stride, pad, 1, max_offset);
    int e = -1;
    // a NaN offset fails these compares: its corners are off the grid
    if (t.h0 >= (float)(r0 - 1) && t.h0 < (float)(r0 + rows) &&
        t.w0 >= (float)(q0 - 1) && t.w0 < (float)(q0 + cols)) {
      e = ((int)t.h0 - r0 + 1) * (TW + 1) + ((int)t.w0 - q0 + 1);
      geo[i] = make_int4(pair, __float_as_int(t.dh), __float_as_int(t.dw),
                         __float_as_int(mask[pair]));
      atomicAdd(&count[e], 1);
    }
    home[i] = e;
  }
  __syncthreads();
  if (warp == 0) {  // start = exclusive prefix sum of count
    int carry = 0;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int c = e0 + lane < E ? count[e0 + lane] : 0;
      int x = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (e0 + lane < E) start[e0 + lane] = cursor[e0 + lane] = carry + x - c;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (home[i] >= 0) bucket[atomicAdd(&cursor[home[i]], 1)] = i;
  __syncthreads();
  // the atomics filled each bucket in no fixed order: sort it by pair, so
  // every sum below runs in one order
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int* bk = bucket + start[e];
    for (int x = 1; x < count[e]; ++x) {
      const int v = bk[x];
      int y = x - 1;
      for (; y >= 0 && bk[y] > v; --y) bk[y + 1] = bk[y];
      bk[y + 1] = v;
    }
  }
  __syncthreads();

  // A warp sums kCells cells at a time, 32 / kCells lanes a cell, each lane
  // kCells 16-byte vectors of its cell's channels in registers: corner (a,
  // bb) of every pair in the bucket of the cell (a, bb) up-left, the four
  // buckets taken as one list, kBatch dsampled rows in flight.
  constexpr int kLanes = 32 / kCells;
  const int sub = lane / kLanes, hl = lane % kLanes;
  const int nv = C / V::n;
  for (int first = warp * kCells; first < rows * cols; first += nw * kCells) {
    const int cell = first + sub;
    const bool has = cell < rows * cols;
    const int ri = cell / cols, qi = cell - ri * cols;
    int L = 0, c0n = 0, c1n = 0, c2n = 0, s0 = 0, s1 = 0, s2 = 0, s3 = 0;
    if (has) {
      const int eh = (ri + 1) * (TW + 1) + (qi + 1);  // the cell in the frame
      const int e1 = eh - 1, e2 = eh - (TW + 1), e3 = eh - (TW + 1) - 1;
      c0n = count[eh], c1n = c0n + count[e1], c2n = c1n + count[e2];
      L = c2n + count[e3];
      // list index -> bucket slot, per corner
      s0 = start[eh], s1 = start[e1] - c0n, s2 = start[e2] - c1n, s3 = start[e3] - c2n;
    }
    int trips = L;  // the longest list of the warp's cells
#pragma unroll
    for (int m = kLanes; m < 32; m <<= 1)
      trips = max(trips, __shfl_xor_sync(0xffffffffu, trips, m));
    for (int vb = 0; vb < nv; vb += 32) {  // 32 vectors of every cell a trip
      float acc[kCells][V::n];
#pragma unroll
      for (int k = 0; k < kCells; ++k)
#pragma unroll
        for (int x = 0; x < V::n; ++x) acc[k][x] = 0.0f;
      for (int t0 = 0; t0 < trips; t0 += kBatch) {
        float w[kBatch], d[kBatch][kCells][V::n];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int idx = t0 + u;
          w[u] = 0.0f;
          if (idx < L) {
            const int j = (idx >= c0n) + (idx >= c1n) + (idx >= c2n);
            const int slot = idx + (j == 0 ? s0 : j == 1 ? s1 : j == 2 ? s2 : s3);
            const int4 g = geo[bucket[slot]];
            const dcn::Tap t = {0.0f, 0.0f, __int_as_float(g.y), __int_as_float(g.z)};
            w[u] = dcn::corner_weight(t, j, __int_as_float(g.w));
#pragma unroll
            for (int k = 0; k < kCells; ++k) {
              const int v = vb + hl + kLanes * k;
              if (v < nv) V::load(dsampled + (int64_t)g.x * C + v * V::n, d[u][k]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (t0 + u < L)
#pragma unroll
            for (int k = 0; k < kCells; ++k)
#pragma unroll
              for (int x = 0; x < V::n; ++x) acc[k][x] = fmaf(w[u], d[u][k][x], acc[k][x]);
      }
      if (has) {
#pragma unroll
        for (int k = 0; k < kCells; ++k) {
          const int v = vb + hl + kLanes * k;
          if (v < nv)
            V::store(dx + (((int64_t)b * H + r0 + ri) * W + q0 + qi) * C + v * V::n, acc[k]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_tile(const void* dsampled, const float* offset,
                        const float* mask, const int* window, void* dx, int B,
                        int H, int W, int C, int Ho, int Wo, int stride,
                        int pad, float max_offset, int TH, int TW, int warps,
                        int cap, cudaStream_t stream) {
  if (TH < 1 || TW < 1 || warps < 1 || warps > 8 || cap < 0 ||
      C % Vec16<T>::n || (int64_t)B * Ho * Wo * kTaps > INT32_MAX)
    return cudaErrorInvalidValue;
  const int n_tr = (H + TH - 1) / TH, n_tc = (W + TW - 1) / TW;
  if (B == 0 || n_tr == 0 || n_tc == 0) return cudaGetLastError();
  const size_t smem = (size_t)cap * (sizeof(int4) + 2 * sizeof(int)) +
                      (size_t)(TH + 1) * (TW + 1) * 3 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      dcn_input_grad_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dcn_input_grad_tile_kernel<T><<<dim3(n_tr * n_tc, B), warps * 32, smem, stream>>>(
      static_cast<const T*>(dsampled), offset, mask, window, static_cast<T*>(dx),
      H, W, C, Ho, Wo, stride, pad, max_offset, TH, TW, n_tr, n_tc, cap);
  return cudaGetLastError();
}

// ---------------------------------------------------------- route "atomic"

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__global__ void dcn_input_grad_kernel(const T* __restrict__ dsampled,
                                      const float* __restrict__ offset,
                                      const float* __restrict__ mask,
                                      float* __restrict__ acc, int H, int W,
                                      int C, int Ho, int Wo, int stride,
                                      int pad, int clamp, float max_offset) {
  __shared__ int64_t s_off[kTaps * 4];
  __shared__ float s_wt[kTaps * 4];

  const int64_t site = blockIdx.x;  // (b, ho, wo) flattened
  const int wo = (int)(site % Wo);
  const int ho = (int)((site / Wo) % Ho);
  const int64_t b = site / ((int64_t)Wo * Ho);

  const int k = threadIdx.x;
  if (k < kTaps) {
    const dcn::Tap t = dcn::tap_at(offset + site * 2 * kTaps + 2 * k, ho, wo, k,
                                   stride, pad, clamp, max_offset);
    const float m = mask[site * kTaps + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float r = dcn::corner_r(t, j), q = dcn::corner_q(t, j);
      const bool ok = dcn::on_grid(r, q, H, W);
      s_off[k * 4 + j] = ok ? (((b * H + (int64_t)r) * W + (int64_t)q) * C) : -1;
      s_wt[k * 4 + j] = ok ? dcn::corner_weight(t, j, m) : 0.0f;
    }
  }
  __syncthreads();

  const T* ds = dsampled + site * (int64_t)kTaps * C;
  const int c4s = C / 4;  // 4-channel vectors per tap
  for (int i = threadIdx.x; i < kTaps * c4s; i += blockDim.x) {
    const int t = i / c4s;
    const int c = (i - t * c4s) * 4;
    const float4 d = load4(ds + (int64_t)t * C + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t off = s_off[t * 4 + j];
      if (off >= 0) {
        const float w = s_wt[t * 4 + j];
        atomicAdd(reinterpret_cast<float4*>(acc + off + c),
                  make_float4(w * d.x, w * d.y, w * d.z, w * d.w));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* dsampled, const float* offset,
                   const float* mask, float* acc, int B, int H, int W, int C,
                   int Ho, int Wo, int stride, int pad, int clamp,
                   float max_offset, cudaStream_t stream) {
  const int64_t sites = (int64_t)B * Ho * Wo;
  if (sites == 0) return cudaGetLastError();
  const int work = kTaps * (C / 4);
  const int threads = work < 192 ? ((work + 31) / 32) * 32 : 192;
  dcn_input_grad_kernel<T><<<(unsigned)sites, threads, 0, stream>>>(
      static_cast<const T*>(dsampled), offset, mask, acc, H, W, C, Ho, Wo,
      stride, pad, clamp, max_offset);
  return cudaGetLastError();
}

}  // namespace

// Route "tile": 3x3 taps, offsets clamped to [-max_offset, max_offset];
// dtype of dsampled 0 = float32, 1 = bfloat16 (dx shares it, offset and mask
// are float32); C a multiple of 16 bytes; dsampled and dx 16-byte aligned.
// A CTA of `warps` (at most 8) warps owns TH x TW cells x all C channels of
// dx. window: int32,
// for each of the ceil(H / TH) tile rows the first and last output row whose
// samples can reach it, then the same for each of the ceil(W / TW) tile
// columns; cap: the most (site, tap) pairs in one tile's window (its rows
// times its columns times 9). Dynamic shared memory cap * 24
// + (TH + 1) * (TW + 1) * 12 bytes, at most 227 KB.
extern "C" int rdt_dcn_input_grad_tile(const void* dsampled, const float* offset,
                                       const float* mask, const int* window,
                                       void* dx, int dtype, int B, int H, int W,
                                       int C, int Ho, int Wo, int stride,
                                       int pad, float max_offset, int TH,
                                       int TW, int warps, int cap, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tile<float>(dsampled, offset, mask, window, dx, B, H, W, C,
                              Ho, Wo, stride, pad, max_offset, TH, TW, warps,
                              cap, s);
  if (dtype == 1)
    return launch_tile<__nv_bfloat16>(dsampled, offset, mask, window, dx, B, H,
                                      W, C, Ho, Wo, stride, pad, max_offset, TH,
                                      TW, warps, cap, s);
  return cudaErrorInvalidValue;
}

// Route "atomic": 3x3 taps, C a multiple of 4. dtype of dsampled: 0 =
// float32, 1 = bfloat16 (offset and mask are always float32, acc always
// float32 and zeroed by the caller). clamp != 0 clamps each offset to
// [-max_offset, max_offset].
extern "C" int rdt_dcn_input_grad(const void* dsampled, const float* offset,
                                  const float* mask, float* acc, int dtype,
                                  int B, int H, int W, int C, int Ho, int Wo,
                                  int stride, int pad, int clamp,
                                  float max_offset, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C % 4) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dsampled, offset, mask, acc, B, H, W, C, Ho, Wo,
                         stride, pad, clamp, max_offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dsampled, offset, mask, acc, B, H, W, C, Ho,
                                 Wo, stride, pad, clamp, max_offset, s);
  return cudaErrorInvalidValue;
}
