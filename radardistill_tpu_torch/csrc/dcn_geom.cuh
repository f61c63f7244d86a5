// What K2 (dcn_sample.cu), K3 (dcn_offset_grad.cu) and K4 (dcn_input_grad.cu)
// share: 16-byte channel vectors, and the DCNv2 sample geometry in the order
// of the plain version (ops/dcn_sample.py::corner_terms), all in float32:
//
//   clamp each offset to [-R, R] (when asked; a NaN stays NaN, as torch.clamp
//   and jnp.clip keep it) -> ph = base + d -> h0 = floor(ph) -> dh = ph - h0
//   -> corner (a, bb) at (h0 + a, w0 + bb) with weight (fh * fw) * m, and the
//   on-grid test made on the float corner position, so that a NaN or a huge
//   offset simply puts every corner off the grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcn {

constexpr int kK = 3;  // 3x3 taps, the only DCN of the model (the CMA's)
constexpr int kTaps = kK * kK;

// CUDA's fminf / fmaxf return the other operand when one is NaN, so a bare
// fminf(fmaxf(d, -r), r) would clamp a NaN offset to -r and sample there.
__device__ __forceinline__ float clamp_offset(float d, float r) {
  return d != d ? d : fminf(fmaxf(d, -r), r);
}

// One tap's sample: the floor of its position and the fractional parts.
struct Tap {
  float h0, w0, dh, dw;
};

// Tap k of output site (ho, wo) with offsets (dy, dx).
__device__ __forceinline__ Tap tap_of(float dy, float dx, int ho, int wo, int k,
                                      int stride, int pad, int clamp,
                                      float max_offset) {
  if (clamp) {
    dy = clamp_offset(dy, max_offset);
    dx = clamp_offset(dx, max_offset);
  }
  const float ph = (float)(ho * stride - pad + k / kK) + dy;
  const float pw = (float)(wo * stride - pad + k % kK) + dx;
  Tap t;
  t.h0 = floorf(ph);
  t.w0 = floorf(pw);
  t.dh = ph - t.h0;
  t.dw = pw - t.w0;
  return t;
}

// The same, reading the tap's (dy, dx) pair at off2.
__device__ __forceinline__ Tap tap_at(const float* off2, int ho, int wo, int k,
                                      int stride, int pad, int clamp,
                                      float max_offset) {
  return tap_of(off2[0], off2[1], ho, wo, k, stride, pad, clamp, max_offset);
}

// Corner j = 2a + bb of a tap: its interpolation factors and position.
__device__ __forceinline__ float corner_fh(const Tap& t, int j) {
  return (j >> 1) ? t.dh : 1.0f - t.dh;
}
__device__ __forceinline__ float corner_fw(const Tap& t, int j) {
  return (j & 1) ? t.dw : 1.0f - t.dw;
}
__device__ __forceinline__ float corner_r(const Tap& t, int j) {
  return t.h0 + (float)(j >> 1);
}
__device__ __forceinline__ float corner_q(const Tap& t, int j) {
  return t.w0 + (float)(j & 1);
}

// The corner's masked weight, (fh * fw) * m as the plain version rounds it.
__device__ __forceinline__ float corner_weight(const Tap& t, int j, float m) {
  return corner_fh(t, j) * corner_fw(t, j) * m;
}

// Float compares: false for a NaN position and for one off the H x W grid.
__device__ __forceinline__ bool on_grid(float r, float q, int H, int W) {
  return r >= 0.0f && r <= (float)(H - 1) && q >= 0.0f && q <= (float)(W - 1);
}

// 16 bytes of T as float32 values, and back
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  // a store marked evict-first (st.global.cs): it keeps L2 for the inputs
  static __device__ __forceinline__ void store_streaming(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ void store_streaming(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

}  // namespace dcn
