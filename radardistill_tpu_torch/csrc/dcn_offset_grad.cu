// K3: DCNv2 backward with respect to the offsets and the modulation mask.
//
// For output site p = (b, ho, wo) and tap k, let v_j = <dsampled[p, k, :],
// x[corner_j, :]> for the four corners j = (a, bb) of the sample at
// (ho*stride - pad + ki + dy_k, wo*stride - pad + kj + dx_k), zero for a
// corner off the grid. With dh, dw the fractional parts, fh = a ? dh : 1-dh,
// fw = bb ? dw : 1-dw, gh = a ? +1 : -1, gw = bb ? +1 : -1:
//
//   g18[p, 2k]   = m_k * sum_j gh_j * fw_j * v_j     (d/d dy_k)
//   g18[p, 2k+1] = m_k * sum_j fh_j * gw_j * v_j     (d/d dx_k)
//   dm9[p, k]    =       sum_j fh_j * fw_j * v_j     (d/d m_k, exact: from
//                                                     the unmasked dsampled)
//
// Offsets are clamped to [-R, R] first when the caller asks for it, as in the
// forward, with the geometry of dcn_geom.cuh (a NaN offset stays NaN and puts
// every corner off the grid, and its NaN factors make g18 and dm9 NaN, as in
// the plain version); the clamp's own pass-through (zero gradient where
// |offset| > R) is applied by the caller on g18.
//
// Replaces the TPU kernel radardistill_tpu/ops/pallas_dcn.py (_offgrad_kernel,
// entered through dcn_offset_grad). That kernel could not gather rows: per
// output row and tap it multiplied dsampled_k with a whole 16-row window of x
// on the MXU (P = dsampled_k @ patch^T) and reduced P against three one-hot
// interpolation matrices. Here the four corner rows are read directly, so the
// work is the 4 dot products of length C that the result needs and nothing of
// the window, the Wo padding or the one-hot builds remains.
//
// What bounds it on the H100: bytes. Per site it reads 9*C values of dsampled
// once (the CMA's 180^2 -> 90^2 site at batch 2 reads 75 MB of bfloat16) and
// at most 36 rows of x, which neighbouring sites share through L2, and writes
// 27 floats; the arithmetic is 8 flops per value read, and the four corner
// rows of each (site, tap) come mostly from L2 (300 MB at that site), which
// is what the kernel waits on. The layout is K2's (dcn_sample.cu): the row of
// dsampled in 16-byte vectors (8 bfloat16 or 4 float32 channels), G lanes per
// (site, tap), G the power of two that covers the row's vectors but at most
// kMaxLanes: a lane walks several vectors with all their reads in flight,
// and several taps share a warp. Every lane computes its tap's geometry from
// broadcast reads of the two offsets, no shared memory and no barrier; it
// reads its vectors of dsampled once, marked evict-first so that L2 keeps x,
// and the four corners' as 16-byte loads, each only where the corner is on
// the grid; it folds its four corner sums into (gy, gx, gm) in float32 before
// any exchange, so the G lanes of a tap reduce three values with segmented
// butterfly shuffles (offsets below G stay inside the tap's aligned group),
// and the tap's first lane writes g18[2k], g18[2k+1] (one 8-byte store) and
// dm9[k]. The grid is persistent (8 blocks of 128 threads an SM) and walks
// (site, tap, channels) in row-major order, so neighbouring warps read
// neighbouring corner rows. (This kernel's first design, one block of 9
// warps per site with 4- and 8-byte loads, is timed against this one by
// tools/torch_dcn_ab.py given its source.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_geom.cuh"

namespace {

using dcn::kTaps;
using dcn::Vec16;

// the most lanes a (site, tap) gets: at C 256 bfloat16, 8 lanes a tap and 4
// taps a warp, each lane walking 4 of the row's 16-byte vectors with their
// reads in flight together (of 4, 8, 16 and 32 lanes a tap, 8 ran fastest at
// the CMA's sites on an H100; 32, a lane a vector, slowest)
constexpr int kMaxLanes = 8;

template <typename T>
__global__ void __launch_bounds__(128)
    dcn_offset_grad_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                           const float* __restrict__ mask, const T* __restrict__ dsampled,
                           float* __restrict__ g18, float* __restrict__ dm9, int H, int W,
                           int C, int Ho, int Wo, int stride, int pad, int clamp,
                           float max_offset, int pairs, int lanes_log2) {
  using V = Vec16<T>;
  using raw_t = typename V::raw_t;
  const int nvec = C / V::n;
  const int G = 1 << lanes_log2;  // lanes per (site, tap)
  const int lane = threadIdx.x & 31, sub = lane & (G - 1);
  const int per_warp = 32 >> lanes_log2;  // (site, tap) pairs per warp
  const int warps = (gridDim.x * blockDim.x) >> 5;
  // 32-bit index arithmetic (the host checks that pairs * 32 and x's size
  // fit) but for dsampled's row, whose offset s * C passes 2^31 at batch 8,
  // 720^2 output sites and 64 channels: a 64-bit division by a runtime value is
  // a long subroutine, and 32-bit offsets of the corners hold fewer
  // registers than pointers
  for (int first = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * per_warp; first < pairs;
       first += warps * per_warp) {
    const int st = first + (lane >> lanes_log2);  // (b, ho, wo, k) flattened
    const bool live = st < pairs;
    const int s = live ? st : pairs - 1;
    const int k = s % kTaps, site = s / kTaps;
    const int wo = site % Wo, ho = (site / Wo) % Ho, b = site / (Wo * Ho);
    const dcn::Tap t = dcn::tap_at(offset + 2 * s, ho, wo, k, stride, pad, clamp, max_offset);
    int corner[4];  // element offsets of the corner rows in x
    bool ok[4];
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float r = dcn::corner_r(t, j), q = dcn::corner_q(t, j);
      ok[j] = live && dcn::on_grid(r, q, H, W);
      corner[j] = ok[j] ? ((b * H + (int)r) * W + (int)q) * C : 0;
      v[j] = 0.0f;
    }
    const T* ds = dsampled + (int64_t)s * C;
#pragma unroll 4
    for (int cv = sub; cv < nvec; cv += G) {
      const int c = cv * V::n;
      raw_t xr[4];  // every read in flight before any FMA
      const raw_t dr = V::ld_streaming(ds + c);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j]) xr[j] = V::ld(x + corner[j] + c);
      float d[V::n];
      V::unpack(dr, d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j]) {
          float xv[V::n];
          V::unpack(xr[j], xv);
#pragma unroll
          for (int e = 0; e < V::n; ++e) v[j] = fmaf(d[e], xv[e], v[j]);
        }
    }
    // the lane's share of the three outputs; a corner off the grid adds
    // 0 * its factors (NaN where an offset is NaN, as in the plain version);
    // a lane past the last pair adds zeros to its own group only
    float gy = 0.0f, gx = 0.0f, gm = 0.0f;
    if (live) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float fh = dcn::corner_fh(t, j), fw = dcn::corner_fw(t, j);
        const float gh = (j >> 1) ? 1.0f : -1.0f, gw = (j & 1) ? 1.0f : -1.0f;
        gy += gh * fw * v[j];
        gx += fh * gw * v[j];
        gm += fh * fw * v[j];
      }
    }
    // the G lanes of each (site, tap) reduce among themselves (every lane of
    // the warp takes part; offsets below G stay inside the group)
    for (int o = G >> 1; o > 0; o >>= 1) {
      gy += __shfl_xor_sync(0xffffffffu, gy, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
      gm += __shfl_xor_sync(0xffffffffu, gm, o);
    }
    if (live && sub == 0) {
      const float m = mask[st];
      *reinterpret_cast<float2*>(g18 + 2 * st) = make_float2(m * gy, m * gx);
      dm9[st] = gm;
    }
  }
}

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 132;
}

template <typename T>
cudaError_t launch(const void* x, const float* offset, const float* mask,
                   const void* dsampled, float* g18, float* dm9, int B, int H,
                   int W, int C, int Ho, int Wo, int stride, int pad,
                   int clamp, float max_offset, int device, cudaStream_t stream) {
  const int64_t pairs = (int64_t)B * Ho * Wo * kTaps;
  if (pairs == 0) return cudaGetLastError();
  const int nvec = C / Vec16<T>::n;
  if (pairs * 32 > INT32_MAX || (int64_t)B * H * W * C > INT32_MAX || C <= 0 ||
      C % Vec16<T>::n)
    return cudaErrorInvalidValue;
  int lanes_log2 = 0;  // G = 2^lanes_log2 covers nvec, at most kMaxLanes
  while ((1 << lanes_log2) < kMaxLanes && (1 << lanes_log2) < nvec) ++lanes_log2;
  constexpr int threads = 128, blocks_per_sm = 8;
  const int64_t most = (int64_t)blocks_per_sm * sm_count(device);
  const int64_t need = (pairs * (1 << lanes_log2) + threads - 1) / threads;
  dcn_offset_grad_kernel<T><<<(int)(need < most ? need : most), threads, 0, stream>>>(
      static_cast<const T*>(x), offset, mask, static_cast<const T*>(dsampled), g18, dm9, H,
      W, C, Ho, Wo, stride, pad, clamp, max_offset, (int)pairs, lanes_log2);
  return cudaGetLastError();
}

}  // namespace

// 3x3 taps, C a multiple of 16 bytes (8 bfloat16 or 4 float32 channels), x
// and dsampled 16-byte aligned, g18 8-byte aligned. dtype: 0 = float32, 1 =
// bfloat16 (x and dsampled share it; offset, mask, g18 and dm9 are always
// float32). clamp != 0 clamps each offset to [-max_offset, max_offset] before
// the geometry.
extern "C" int rdt_dcn_offset_grad(const void* x, const float* offset,
                                   const float* mask, const void* dsampled,
                                   float* g18, float* dm9, int dtype, int B,
                                   int H, int W, int C, int Ho, int Wo,
                                   int stride, int pad, int clamp,
                                   float max_offset, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, offset, mask, dsampled, g18, dm9, B, H, W, C, Ho, Wo, stride,
                         pad, clamp, max_offset, device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, offset, mask, dsampled, g18, dm9, B, H, W, C, Ho, Wo,
                                 stride, pad, clamp, max_offset, device, s);
  return cudaErrorInvalidValue;
}
