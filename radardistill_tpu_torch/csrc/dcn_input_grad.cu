// K4: DCNv2 backward with respect to the input: the transpose of the masked
// bilinear tap sampling of dcn_sample.cu.
//
//   acc[b, r, q, c] += m_k * fh * fw * dsampled[b, ho, wo, k*C + c]
//
// for every output site (b, ho, wo), tap k and corner (r, q) of the sample at
// (ho*stride - pad + ki + dy_k, wo*stride - pad + kj + dx_k) that lies on the
// grid; offsets clamped to [-R, R] first when the caller asks for it. acc is
// a float32 (B, H, W, C) buffer that the caller zeroes before the launch and
// casts to x's dtype after it, so the sum is rounded once.
//
// Replaces the TPU kernel radardistill_tpu/ops/pallas_dcn.py (_grad_kernel,
// entered through dcn_input_grad). A TPU cannot scatter rows, so that kernel
// turned the scatter into a matmul: per block of 10 input rows it built
// one-hot matrices from every sample of a bounded window of output rows (the
// +-R clamp bounded it) and accumulated M^T @ (mask * dsampled) in VMEM. Here
// a sample adds to its four corner cells directly; no window, no 10-row
// blocks, no packing of offsets and mask into 128 lanes.
//
// A scatter with atomics was taken over a gather per input cell because the
// gather needs the clamp to bound the sites that can reach a cell, and the
// unclamped call (shapes outside the reference's gate) has no such bound: one
// kernel serves both. The price is that the order of the float32 additions
// changes from run to run, so dx repeats to rounding and not bit for bit.
//
// What bounds it on the H100: bytes and the L2's atomic units. Per site it
// reads 9*C values once and issues up to 36*C float32 additions to memory;
// a (2, 180, 180, 256) float32 buffer is 66 MB and does not stay in the 50 MB
// L2. The design: one block per output site; the first 9 threads compute the
// tap geometry and the masked corner weights into shared memory once; then
// every thread takes 4 neighbouring channels of one tap (an 8- or 16-byte
// load) and issues one 16-byte vector atomic (red.global.add.v4.f32, sm_90)
// per corner, a quarter of the instructions that scalar atomics would need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 3;
constexpr int kTaps = kK * kK;

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
    const int ki = k / kK, kj = k % kK;
    float dy = offset[site * 2 * kTaps + 2 * k];
    float dx = offset[site * 2 * kTaps + 2 * k + 1];
    if (clamp) {
      dy = fminf(fmaxf(dy, -max_offset), max_offset);
      dx = fminf(fmaxf(dx, -max_offset), max_offset);
    }
    const float ph = (float)(ho * stride - pad + ki) + dy;
    const float pw = (float)(wo * stride - pad + kj) + dx;
    const float h0 = floorf(ph);
    const float w0 = floorf(pw);
    const float dh = ph - h0;
    const float dw = pw - w0;
    const float m = mask[site * kTaps + k];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const float fh = a ? dh : 1.0f - dh;
        const float fw = bb ? dw : 1.0f - dw;
        const float r = h0 + (float)a;
        const float q = w0 + (float)bb;
        // float compares: a NaN or huge offset is simply off the grid
        const bool ok = r >= 0.0f && r <= (float)(H - 1) && q >= 0.0f &&
                        q <= (float)(W - 1);
        const int j = k * 4 + a * 2 + bb;
        s_off[j] = ok ? (((b * H + (int64_t)r) * W + (int64_t)q) * C) : -1;
        s_wt[j] = ok ? fh * fw * m : 0.0f;
      }
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

// 3x3 taps, C a multiple of 4. dtype of dsampled: 0 = float32, 1 = bfloat16
// (offset and mask are always float32, acc always float32 and zeroed by the
// caller). clamp != 0 clamps each offset to [-max_offset, max_offset].
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
