// K6: one fused float conv link of the frozen LiDAR teacher, and K9: the
// plain 3x3 convolution on the same device code.
//
//   acc = conv(x, k)            stride 1, 3x3 window padded (1, 1) or 2x2
//                               window padded (1, 0); products of x's type,
//                               float32 accumulation
//   y   = acc * alpha + beta    float32, per output channel
//   y  += r                     with a residual r (x's type, added as float32)
//   y   = relu(y) * mask        compact phase mask (B, H, W, nph)
//   out = y rounded once to x's type
// or, with identity set (K9), out = acc rounded once to x's type.
//
// K6 replaces the TPU kernel radardistill_tpu/ops/pallas_conv_block.py
// (_block_kernel in bf16 mode, entered through fp_block_conv -> _block_call);
// K9 replaces radardistill_tpu/ops/pallas_wide_conv.py (_wide_kernel, entered
// through conv3x3_wide -> _wide_call), whose body is the same product without
// the epilogue. Both TPU kernels exist to feed a 128x128 matrix unit a wide N:
// a ky-stacked (C, kh*Co_pad) operand, C and Co padded to 128 lanes, W padded
// to 16 sublanes, C = 64 links paired along W. None of that is carried over:
// every dimension keeps its real size and the weight its (kh, kw, C, Co)
// layout.
//
// What bounds it on the H100: operations. The links run from
// (2, 720, 720, 64) x (3, 3, 64, 64), 76 G operations over 270 MB, to
// (2, 90, 90, 1024) x (2, 2, 1024, 256), 34 G operations over 37 MB: 280 to
// 900 operations per byte, at or above the bfloat16 ridge of 295. So the
// bfloat16 kernel feeds the tensor cores (mma.sync.m16n8k16, float32
// accumulators) from shared memory through the tiled loop of
// csrc/conv_tile.cuh: a block owns 8 x 16 pixels by up to 128 output channels,
// streams the weight and the input in chunks of 32 channels, and two blocks
// share an SM. wgmma, TMA and a pipelined ring are left for later.
//
// The float32 kernel serves the float32 model (the card-vs-CPU comparisons):
// plain FFMA in full float32, no TF32. A block owns 8 x 16 pixels by 64
// output channels, a thread 4 pixels by 8 channels; chunks of 8 input
// channels go through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

// the link's epilogue on one accumulator; every float operation rounds once
__device__ __forceinline__ float fp_epilogue(float acc, float alpha, float beta,
                                             bool has_res, float r, float m) {
  float y = __fadd_rn(__fmul_rn(acc, alpha), beta);
  if (has_res) y = __fadd_rn(y, r);
  y = fmaxf(y, 0.0f);
  return __fmul_rn(y, m);
}

template <int NT, int KH>
__global__ void __launch_bounds__(rdt::NTHREADS, 2)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ k,
                 const float* __restrict__ ab, const int8_t* __restrict__ mask,
                 const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ out,
                 int B, int H, int W, int C, int Co, int nph, int identity, int kcw) {
  constexpr int COT = 16 * NT;
  extern __shared__ __align__(16) uint32_t smem_u[];
  const int n_cot = Co / COT;
  const int cot = blockIdx.x % n_cot, tile = blockIdx.x / n_cot;
  const int tiles_x = (W + rdt::TW - 1) / rdt::TW, tiles_y = (H + rdt::TH - 1) / rdt::TH;
  const int b = tile / (tiles_y * tiles_x);
  const int y0 = ((tile / tiles_x) % tiles_y) * rdt::TH, x0 = (tile % tiles_x) * rdt::TW;
  const int co0 = cot * COT;

  float acc[2][NT][4];
  rdt::conv_tile<rdt::BF16, NT, KH>(acc, x, k, smem_u, b, y0, x0, co0, H, 0, W, C, Co, kcw,
                                    0u);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const bool has_res = res != nullptr;
  const int cpp = identity ? 1 : Co / nph;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int yy = y0 + 2 * wm + mt;
    if (yy >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xx = x0 + g + 8 * half;
      if (xx >= W) continue;
      const size_t pix = ((size_t)b * H + yy) * W + xx;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + wn * 8 * NT + nt * 8 + 2 * t;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (!identity) {
          const int8_t* mrow = mask + pix * nph;
          const float m0 = (float)mrow[co / cpp], m1 = (float)mrow[(co + 1) / cpp];
          float r0 = 0.0f, r1 = 0.0f;
          if (has_res) {
            const __nv_bfloat162 rr =
                *reinterpret_cast<const __nv_bfloat162*>(res + pix * Co + co);
            r0 = __bfloat162float(rr.x);
            r1 = __bfloat162float(rr.y);
          }
          v0 = fp_epilogue(v0, __ldg(ab + co), __ldg(ab + Co + co), has_res, r0, m0);
          v1 = fp_epilogue(v1, __ldg(ab + co + 1), __ldg(ab + Co + co + 1), has_res, r1, m1);
        }
        __nv_bfloat162 h;
        h.x = __float2bfloat16_rn(v0);
        h.y = __float2bfloat16_rn(v1);
        *reinterpret_cast<__nv_bfloat162*>(out + pix * Co + co) = h;
      }
    }
  }
}

template <int NT, int KH>
cudaError_t launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* k, const float* ab,
                        const int8_t* mask, const __nv_bfloat16* res, __nv_bfloat16* out,
                        int B, int H, int W, int C, int Co, int nph, int identity,
                        cudaStream_t stream) {
  const int kcw = (C / 2) % 16 == 0 ? 16 : 8;
  const int smem = 4 * rdt::tile_smem_words(KH, kcw, 16 * NT);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bf16_kernel<NT, KH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((H + rdt::TH - 1) / rdt::TH) *
                           ((W + rdt::TW - 1) / rdt::TW) * (Co / (16 * NT));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_bf16_kernel<NT, KH><<<(int)blocks, rdt::NTHREADS, smem, stream>>>(
      x, k, ab, mask, res, out, B, H, W, C, Co, nph, identity, kcw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32

constexpr int F_COT = 64;   // output channels of one block
constexpr int F_KC = 8;     // input channels per chunk
constexpr int F_XS = F_KC + 1;  // input pixel stride in shared memory, floats

template <int KH>
__global__ void __launch_bounds__(rdt::NTHREADS)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ k,
                const float* __restrict__ ab, const int8_t* __restrict__ mask,
                const float* __restrict__ res, float* __restrict__ out, int B, int H,
                int W, int C, int Co, int nph, int identity) {
  constexpr int XR = rdt::TH + KH - 1, XC = rdt::TW + KH - 1;
  __shared__ __align__(16) float ws[KH * KH][F_KC][F_COT];
  __shared__ float xs[XR * XC][F_XS];

  const int n_cot = (Co + F_COT - 1) / F_COT;
  const int cot = blockIdx.x % n_cot, tile = blockIdx.x / n_cot;
  const int tiles_x = (W + rdt::TW - 1) / rdt::TW, tiles_y = (H + rdt::TH - 1) / rdt::TH;
  const int b = tile / (tiles_y * tiles_x);
  const int y0 = ((tile / tiles_x) % tiles_y) * rdt::TH, x0 = (tile % tiles_x) * rdt::TW;
  const int co0 = cot * F_COT;

  const int tid = threadIdx.x;
  const int cg = tid & 7;            // channels co0 + 8*cg .. + 7
  const int pg = tid >> 3;           // 32 pixel groups of 4 columns
  const int pr = pg >> 2, pc0 = (pg & 3) * 4;

  float acc[4][8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[j][e] = 0.0f;

#pragma unroll 1
  for (int c0 = 0; c0 < C; c0 += F_KC) {
    __syncthreads();
    // weight slice: [tap][c][co], 4 output channels per item
    for (int idx = tid; idx < KH * KH * F_KC * (F_COT / 4); idx += rdt::NTHREADS) {
      const int co4 = idx % (F_COT / 4), r = idx / (F_COT / 4);
      const int tap = r / F_KC, c = r - tap * F_KC;
      const int co = co0 + 4 * co4;
      float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (co < Co)
        w = *reinterpret_cast<const float4*>(k + ((size_t)tap * C + c0 + c) * Co + co);
      *reinterpret_cast<float4*>(&ws[tap][c][4 * co4]) = w;
    }
    // input tile with its halo: two 16-byte vectors per pixel
    for (int idx = tid; idx < XR * XC * 2; idx += rdt::NTHREADS) {
      const int v = idx & 1, p = idx >> 1;
      const int j = p % XC, i = p / XC;
      const int iy = y0 - 1 + i, ix = x0 - 1 + j;
      float4 xv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        xv = *reinterpret_cast<const float4*>(
            x + (((size_t)b * H + iy) * W + ix) * C + c0 + 4 * v);
      xs[p][4 * v] = xv.x;
      xs[p][4 * v + 1] = xv.y;
      xs[p][4 * v + 2] = xv.z;
      xs[p][4 * v + 3] = xv.w;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < KH * KH; ++tap) {
      const int ky = tap / KH, kx = tap - ky * KH;
      const float* xrow = &xs[(pr + ky) * XC + pc0 + kx][0];
#pragma unroll
      for (int c = 0; c < F_KC; ++c) {
        const float4 w0 = *reinterpret_cast<const float4*>(&ws[tap][c][8 * cg]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ws[tap][c][8 * cg + 4]);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = xrow[j * F_XS + c];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[j][e] = fmaf(xv, wv[e], acc[j][e]);
        }
      }
    }
  }

  const int yy = y0 + pr;
  if (yy >= H) return;
  const bool has_res = res != nullptr;
  const int cpp = identity ? 1 : Co / nph;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int xx = x0 + pc0 + j;
    if (xx >= W) continue;
    const size_t pix = ((size_t)b * H + yy) * W + xx;
#pragma unroll
    for (int e4 = 0; e4 < 2; ++e4) {
      const int co = co0 + 8 * cg + 4 * e4;
      if (co >= Co) continue;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[j][4 * e4 + e];
        if (!identity) {
          const float m = (float)mask[pix * nph + (co + e) / cpp];
          const float r = has_res ? res[pix * Co + co + e] : 0.0f;
          v[e] = fp_epilogue(v[e], __ldg(ab + co + e), __ldg(ab + Co + co + e), has_res, r, m);
        }
      }
      *reinterpret_cast<float4*>(out + pix * Co + co) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int KH>
cudaError_t launch_f32(const float* x, const float* k, const float* ab, const int8_t* mask,
                       const float* res, float* out, int B, int H, int W, int C, int Co,
                       int nph, int identity, cudaStream_t stream) {
  const long long blocks = (long long)B * ((H + rdt::TH - 1) / rdt::TH) *
                           ((W + rdt::TW - 1) / rdt::TW) * ((Co + F_COT - 1) / F_COT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_f32_kernel<KH><<<(int)blocks, rdt::NTHREADS, 0, stream>>>(
      x, k, ab, mask, res, out, B, H, W, C, Co, nph, identity);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C), k (kh, kh, C, Co), res (B, H, W, Co) or null and out
// (B, H, W, Co) all bfloat16 (dtype 2) or all float32 (dtype 1); ab (2, Co)
// float32, rows alpha, beta; mask (B, H, W, nph) int8. With identity set, ab,
// mask and res are not read (null) and out = conv(x, k). x, k and res are
// 16-byte aligned, kh in {2, 3}, nph divides Co. bfloat16: C % 16 == 0, Co in
// {16, 32, 64} or a multiple of 128. float32: C % 8 == 0, Co % 4 == 0.
extern "C" int rdt_conv_block_fp(const void* x, const void* k, const void* ab,
                                 const void* mask, const void* res, void* out, int B,
                                 int H, int W, int C, int Co, int kh, int nph, int dtype,
                                 int identity, int device, void* stream) {
  if ((kh != 2 && kh != 3) || (dtype != 1 && dtype != 2) ||
      (!identity && (nph <= 0 || Co % nph != 0)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  auto ms = static_cast<const int8_t*>(mask);
  auto abs_ = static_cast<const float*>(ab);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (C % 8 != 0 || Co % 4 != 0) return cudaErrorInvalidValue;
    auto xs = static_cast<const float*>(x);
    auto ks = static_cast<const float*>(k);
    auto rs = static_cast<const float*>(res);
    auto os = static_cast<float*>(out);
    return kh == 3 ? launch_f32<3>(xs, ks, abs_, ms, rs, os, B, H, W, C, Co, nph, identity, st)
                   : launch_f32<2>(xs, ks, abs_, ms, rs, os, B, H, W, C, Co, nph, identity, st);
  }
  if (C % 16 != 0) return cudaErrorInvalidValue;
  auto xs = static_cast<const __nv_bfloat16*>(x);
  auto ks = static_cast<const __nv_bfloat16*>(k);
  auto rs = static_cast<const __nv_bfloat16*>(res);
  auto os = static_cast<__nv_bfloat16*>(out);
#define RDT_BF16(NT)                                                                   \
  return kh == 3 ? launch_bf16<NT, 3>(xs, ks, abs_, ms, rs, os, B, H, W, C, Co, nph,   \
                                      identity, st)                                    \
                 : launch_bf16<NT, 2>(xs, ks, abs_, ms, rs, os, B, H, W, C, Co, nph,   \
                                      identity, st)
  if (Co == 16) RDT_BF16(1);
  if (Co == 32) RDT_BF16(2);
  if (Co == 64) RDT_BF16(4);
  if (Co % 128 == 0) RDT_BF16(8);
  return cudaErrorInvalidValue;
#undef RDT_BF16
}
