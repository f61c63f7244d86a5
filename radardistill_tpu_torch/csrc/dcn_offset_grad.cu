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
// every corner off the grid); the clamp's own pass-through (zero gradient where
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
// once and at most 36 rows of x (neighbouring sites share them through L2),
// and writes 27 floats; the arithmetic is 8 flops per value read. The design:
// one block per output site, one warp per tap, every lane holding pairs of
// neighbouring channels (4- or 8-byte loads, a warp reads 128 or 256
// contiguous bytes per request), float32 accumulation, a shuffle reduction of
// the four corner sums, and lane 0 combines them into the three outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_geom.cuh"

namespace {

using dcn::kTaps;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void dcn_offset_grad_kernel(
    const T* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, const T* __restrict__ dsampled,
    float* __restrict__ g18, float* __restrict__ dm9, int H, int W, int C,
    int Ho, int Wo, int stride, int pad, int clamp, float max_offset) {
  const int64_t site = blockIdx.x;  // (b, ho, wo) flattened
  const int wo = (int)(site % Wo);
  const int ho = (int)((site / Wo) % Ho);
  const int64_t b = site / ((int64_t)Wo * Ho);
  const int k = threadIdx.x >> 5;  // one warp per tap
  const int lane = threadIdx.x & 31;

  // every lane of the warp computes the tap's geometry (same values)
  const dcn::Tap t = dcn::tap_at(offset + site * 2 * kTaps + 2 * k, ho, wo, k,
                                 stride, pad, clamp, max_offset);

  const T* corner[4];
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float r = dcn::corner_r(t, j), q = dcn::corner_q(t, j);
    ok[j] = dcn::on_grid(r, q, H, W);
    corner[j] = ok[j] ? x + ((b * H + (int64_t)r) * W + (int64_t)q) * C : x;
  }

  const T* ds = dsampled + (site * kTaps + k) * (int64_t)C;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 2 * lane; c < C; c += 64) {
    const float2 d = load2(ds + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ok[j]) {
        const float2 xv = load2(corner[j] + c);
        v[j] = fmaf(d.x, xv.x, v[j]);
        v[j] = fmaf(d.y, xv.y, v[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], s);
  }

  if (lane == 0) {
    float gy = 0.0f, gx = 0.0f, gm = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float fh = dcn::corner_fh(t, j);
      const float fw = dcn::corner_fw(t, j);
      const float gh = (j >> 1) ? 1.0f : -1.0f;
      const float gw = (j & 1) ? 1.0f : -1.0f;
      gy += gh * fw * v[j];
      gx += fh * gw * v[j];
      gm += fh * fw * v[j];
    }
    const float m = mask[site * kTaps + k];
    g18[site * 2 * kTaps + 2 * k] = m * gy;
    g18[site * 2 * kTaps + 2 * k + 1] = m * gx;
    dm9[site * kTaps + k] = gm;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* offset, const float* mask,
                   const void* dsampled, float* g18, float* dm9, int B, int H,
                   int W, int C, int Ho, int Wo, int stride, int pad,
                   int clamp, float max_offset, cudaStream_t stream) {
  const int64_t sites = (int64_t)B * Ho * Wo;
  if (sites == 0) return cudaGetLastError();
  dcn_offset_grad_kernel<T><<<(unsigned)sites, 32 * kTaps, 0, stream>>>(
      static_cast<const T*>(x), offset, mask, static_cast<const T*>(dsampled),
      g18, dm9, H, W, C, Ho, Wo, stride, pad, clamp, max_offset);
  return cudaGetLastError();
}

}  // namespace

// 3x3 taps, C even. dtype: 0 = float32, 1 = bfloat16 (x and dsampled share
// it; offset, mask, g18 and dm9 are always float32). clamp != 0 clamps each
// offset to [-max_offset, max_offset] before the geometry.
extern "C" int rdt_dcn_offset_grad(const void* x, const float* offset,
                                   const float* mask, const void* dsampled,
                                   float* g18, float* dm9, int dtype, int B,
                                   int H, int W, int C, int Ho, int Wo,
                                   int stride, int pad, int clamp,
                                   float max_offset, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (C % 2) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, offset, mask, dsampled, g18, dm9, B, H, W, C, Ho,
                         Wo, stride, pad, clamp, max_offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, offset, mask, dsampled, g18, dm9, B, H, W,
                                 C, Ho, Wo, stride, pad, clamp, max_offset, s);
  return cudaErrorInvalidValue;
}
