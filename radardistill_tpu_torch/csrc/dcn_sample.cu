// K2: DCNv2 masked bilinear tap sampling, tap-major output.
//
//   out[b, ho, wo, k*C + c] = mask[b, ho, wo, k] *
//       bilinear(x[b, :, :, c], ho*stride - pad + ki + dy_k,
//                               wo*stride - pad + kj + dx_k)
//
// with (dy_k, dx_k) = offset[b, ho, wo, 2k : 2k+2], clamped to [-R, R] when
// the caller asks for it, and zeros for corners off the grid.
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
// (the CMA's 180^2 -> 90^2 site writes 90*90*9*256 bf16 = 37 MB) and reads at
// most 4*9 input rows of C values, which mostly hit L2 because neighbouring
// sites sample neighbouring rows. The arithmetic (4 FMAs per written value)
// is negligible. The design gives one block to one output site: the first
// 9 threads compute the tap geometry and the corner weights once, in f32 as
// the TPU kernel does, into shared memory; then the threads run along C, so
// every corner read and every output write is coalesced over the contiguous
// NHWC channel axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 3;  // 3x3 taps, the only DCN of the model (the CMA's)
constexpr int kTaps = kK * kK;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void dcn_sample_kernel(const T* __restrict__ x,
                                  const float* __restrict__ offset,
                                  const float* __restrict__ mask,
                                  T* __restrict__ out, int H, int W, int C,
                                  int Ho, int Wo, int stride, int pad,
                                  int clamp, float max_offset) {
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

  T* o = out + site * (int64_t)kTaps * C;
  for (int t = 0; t < kTaps; ++t) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t off = s_off[t * 4 + j];
        if (off >= 0) acc += s_wt[t * 4 + j] * to_f32(x[off + c]);
      }
      store(o + (int64_t)t * C + c, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* offset, const float* mask,
                   void* out, int B, int H, int W, int C, int Ho, int Wo,
                   int stride, int pad, int clamp, float max_offset,
                   cudaStream_t stream) {
  const int64_t sites = (int64_t)B * Ho * Wo;
  if (sites == 0) return cudaGetLastError();
  // a multiple of 32, at least one thread per tap, at most 256
  const int threads = C < 256 ? ((C + 31) / 32) * 32 : 256;
  dcn_sample_kernel<T><<<(unsigned)sites, threads, 0, stream>>>(
      static_cast<const T*>(x), offset, mask, static_cast<T*>(out), H, W, C,
      Ho, Wo, stride, pad, clamp, max_offset);
  return cudaGetLastError();
}

}  // namespace

// 3x3 taps. dtype: 0 = float32, 1 = bfloat16 (x and out share it; offset
// and mask are always float32). clamp != 0 clamps each offset to
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
                         clamp, max_offset, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, offset, mask, out, B, H, W, C, Ho, Wo,
                                 stride, pad, clamp, max_offset, s);
  return cudaErrorInvalidValue;
}
