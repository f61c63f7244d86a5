// K2: DCNv2 masked bilinear tap sampling, tap-major output.
//
//   out[b, ho, wo, k*C + c] = mask[b, ho, wo, k] *
//       bilinear(x[b, :, :, c], ho*stride - pad + ki + dy_k,
//                               wo*stride - pad + kj + dx_k)
//
// with (dy_k, dx_k) = offset[b, ho, wo, 2k : 2k+2], clamped to [-R, R] when
// the caller asks for it (a NaN offset stays NaN and reads zeros, as in the
// reference), and zeros for corners off the grid. The geometry is
// dcn_geom.cuh's, shared with K3 and K4.
//
// Replaces the TPU kernel radardistill_tpu/ops/pallas_dcn.py (_sample_kernel,
// entered through dcn_sample). On the TPU a row gather paid a fixed cost per
// row, so that kernel built, per output row and tap, a one-hot interpolation
// matrix over a 16-row window of the input and ran it through the MXU; the
// +-R clamp existed to keep every sample inside that window, and Wo was padded
// to the 16-column tiling. Here a corner read is an ordinary load: there is no
// window, no padding of Wo, and the clamp is only kept where the reference
// applies it (the caller passes it), so the kernel and the plain PyTorch
// version compute one function.
//
// What bounds it on the H100: bytes. Per output site it writes 9*C values
// (the CMA's 180^2 -> 90^2 site at batch 2 writes 75 MB of bfloat16) and reads
// 4*9 input rows of C values, which mostly hit L2 because neighbouring sites
// sample neighbouring rows. The arithmetic (4 FMAs per written value) is
// negligible. The design: one thread per 16 bytes of one (site, tap) row of
// the output (8 bfloat16 or 4 float32 channels; at C 256 a warp is one tap of
// one site). Every thread computes its tap's geometry itself from a broadcast
// read of the tap's two offsets and its mask value: no shared memory and no
// barrier before the first load. It issues the four corner reads as 16-byte
// loads, accumulates in float32 in the plain version's corner order and
// stores 16 bytes, marked evict-first so that the 75 MB of output leave L2 to
// the input. The grid is persistent (8 blocks of 128 threads an SM) and walks
// (site, tap, channels) in row-major order, so neighbouring warps read
// neighbouring input rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dcn_geom.cuh"

namespace {

using dcn::kTaps;
using dcn::Vec16;

template <typename T>
__global__ void __launch_bounds__(128)
    dcn_sample_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                      const float* __restrict__ mask, T* __restrict__ out, int H,
                      int W, int C, int Ho, int Wo, int stride, int pad,
                      int clamp, float max_offset, int items) {
  using V = Vec16<T>;
  const int nvec = C / V::n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += gridDim.x * blockDim.x) {
    const int st = i / nvec;  // (b, ho, wo, k) flattened
    const int c = (i - st * nvec) * V::n;
    const int k = st % kTaps;
    const int site = st / kTaps;
    const int wo = site % Wo;
    const int ho = (site / Wo) % Ho;
    const int b = site / (Wo * Ho);
    const dcn::Tap t = dcn::tap_at(offset + 2 * (int64_t)st, ho, wo, k, stride,
                                   pad, clamp, max_offset);
    const float m = mask[st];

    float val[4][V::n];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // all four reads in flight before any FMA
      const float r = dcn::corner_r(t, j), q = dcn::corner_q(t, j);
      ok[j] = dcn::on_grid(r, q, H, W);
      if (ok[j])
        V::load(x + (((int64_t)b * H + (int)r) * W + (int)q) * C + c, val[j]);
    }
    float acc[V::n];
#pragma unroll
    for (int e = 0; e < V::n; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ok[j]) {
        const float w = dcn::corner_weight(t, j, m);
#pragma unroll
        for (int e = 0; e < V::n; ++e) acc[e] = fmaf(w, val[j][e], acc[e]);
      }
    }
    V::store_streaming(out + (int64_t)st * C + c, acc);
  }
}

int sm_count(int device) {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 132;
}

template <typename T>
cudaError_t launch(const void* x, const float* offset, const float* mask,
                   void* out, int B, int H, int W, int C, int Ho, int Wo,
                   int stride, int pad, int clamp, float max_offset, int device,
                   cudaStream_t stream) {
  const int64_t items = (int64_t)B * Ho * Wo * kTaps * (C / Vec16<T>::n);
  if (items == 0) return cudaGetLastError();
  if (items > INT32_MAX || C % Vec16<T>::n) return cudaErrorInvalidValue;
  constexpr int threads = 128, blocks_per_sm = 8;
  const int64_t most = (int64_t)blocks_per_sm * sm_count(device);
  const int64_t need = (items + threads - 1) / threads;
  dcn_sample_kernel<T><<<(int)(need < most ? need : most), threads, 0, stream>>>(
      static_cast<const T*>(x), offset, mask, static_cast<T*>(out), H, W, C,
      Ho, Wo, stride, pad, clamp, max_offset, (int)items);
  return cudaGetLastError();
}

}  // namespace

// 3x3 taps, C a multiple of 16 bytes (8 bfloat16 or 4 float32 channels), x
// and out 16-byte aligned. dtype: 0 = float32, 1 = bfloat16 (x and out share
// it; offset and mask are always float32). clamp != 0 clamps each offset to
// [-max_offset, max_offset].
extern "C" int rdt_dcn_sample(const void* x, const float* offset,
                              const float* mask, void* out, int dtype, int B,
                              int H, int W, int C, int Ho, int Wo, int stride,
                              int pad, int clamp, float max_offset, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, offset, mask, out, B, H, W, C, Ho, Wo, stride, pad,
                         clamp, max_offset, device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, offset, mask, out, B, H, W, C, Ho, Wo,
                                 stride, pad, clamp, max_offset, device, s);
  return cudaErrorInvalidValue;
}
