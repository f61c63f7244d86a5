// K1: one fused int8 conv link of the frozen LiDAR teacher.
//
//   acc = conv(x, k)            int8 x int8 -> int32, stride 1, 3x3 window
//                               padded (1, 1) or 2x2 window padded (1, 0)
//   y   = acc * alpha + beta    float32, per output channel
//   y  += r * rs + rsh          with a residual r (int8)
//   y   = relu(y) * mask        compact phase mask (B, H, W, nph)
//   q   = clip(rint(y * s_out) - 127, -127, 127)   int8, or y as f32 / bf16
//
// Replaces the TPU kernel radardistill_tpu/ops/pallas_conv_block.py
// (_block_kernel in int8 mode, entered through int8_block ->
// int8_block_conv_v2 -> _block_call). That kernel is shaped by the TPU: a
// ky-stacked (C, kh*Co_pad) operand so one big dot feeds the 128x128 matrix
// unit, C and Co padded to 128 lanes, W padded to 8, a clamped halo DMA with
// a row shift on the edge programs, and a selector matmul to expand the phase
// mask. None of that is carried over. Here the weight comes in its natural
// (kh, kw, C, Co) int8 layout, out-of-range taps read the value zpad, the
// mask is one byte per (pixel, phase), and no dimension is padded.
//
// What bounds it on the H100: operations. One link at the teacher's stage 1
// is x (2, 720, 720, 128) * k (3, 3, 128, 128): 153 G multiply-adds over
// about 270 MB of traffic, 1100 operations per byte, far above the card's
// int8 ridge. The design therefore feeds the tensor cores
// (mma.sync.m16n8k32.s8, int32 accumulators) and keeps both operands in
// shared memory:
//   - a block is persistent (one per SM). It repacks the whole weight once
//     into shared memory as 32-bit words of four consecutive input channels,
//     [tap][C/4][Co], which is both the B fragment of the mma and what a
//     dp4a would want; the row stride Co + 8 words makes the fragment loads
//     conflict-free.
//   - it then walks over output tiles of 8 x 16 pixels. For each it loads
//     the (8 + kh - 1) x (16 + kh - 1) input pixels with their halo as words
//     [row][col][C/4] (pixel stride C/4 + 4 words, conflict-free A loads),
//     16 bytes at a time; cells outside the image hold zpad.
//   - 8 warps: warp (wm, wn) computes tile rows 2*wm, 2*wm+1 (two m16 tiles,
//     m = the 16 columns) by half of the output channels. Per tap and per 32
//     input channels: A and B fragments straight from shared memory, then
//     2 * NT mma.
//   - the epilogue runs on the accumulators in registers with explicit
//     round-to-nearest multiplies and adds (no fused multiply-add: one ulp of
//     difference flips a code where y * s_out lands on a half), rintf for
//     the half-to-even rounding, and writes two adjacent channels at a time.
// Shared memory holds weight + tile: 157 KB + 26 KB at C = Co = 128, kh = 3,
// so one block of 256 threads per SM.
//
// That is the resident variant, for weights that fit. The deeper links of the
// chain do not: (3, 3, 256, 256) is 590 KB, (2, 2, 512, 256) 512 KB,
// (2, 2, 1024, 256) 1 MB. The streamed variant (conv_stream_kernel) tiles Co
// by 128 and walks over C in chunks, staging the weight slice and the input
// tile of each chunk in shared memory (csrc/conv_tile.cuh); two blocks share
// an SM so one loads while the other multiplies. Same mma, same epilogue.
//
// K7, the first-generation chain link (rdt_chain_conv): the math of K1 on
// other operands. It replaces radardistill_tpu/ops/pallas_int8_conv.py
// (_chain_kernel, entered through int8_block_conv -> _chain_call): the input
// arrives pre-padded in H with rows of zpad, (1, kh - 2) of them, the mask is
// a full (B, H, W, Co) int8 tensor read per output channel, and the output is
// int8 only. It runs the streamed kernel with that addressing; the product
// and the epilogue are the device code K1 uses. The TPU kernel's W padding to
// 8, its lane padding of C and Co to 128 and its ky-stacked operand are not
// carried over. Operation-bound like K1: (2, 90, 90, 1024) x (2, 2, 1024,
// 256) is 34 G operations over 20 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile.cuh"

namespace {

constexpr int TH = 8;    // tile rows
constexpr int TW = 16;   // tile columns (the m of one mma)
constexpr int NTHREADS = 256;

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the link's epilogue on one accumulator; every float operation rounds once
__device__ __forceinline__ float epilogue(int acc, float alpha, float beta,
                                          bool has_res, int r, float rs,
                                          float rsh, float m) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), alpha), beta);
  if (has_res)
    y = __fadd_rn(y, __fadd_rn(__fmul_rn(__int2float_rn(r), rs), rsh));
  y = fmaxf(y, 0.0f);
  return __fmul_rn(y, m);
}

__device__ __forceinline__ int requant(float y, float s_out) {
  float q = rintf(__fmul_rn(y, s_out)) - 127.0f;
  return (int)fminf(fmaxf(q, -127.0f), 127.0f);
}

// two adjacent channels of one pixel: requantized to int8 (out_kind 0), or
// the float values as float32 (1) or bfloat16 (2)
__device__ __forceinline__ void write_pair(void* out, size_t o, int out_kind, float v0,
                                           float v1, float s_out) {
  if (out_kind == 0) {
    char2 q;
    q.x = (signed char)requant(v0, s_out);
    q.y = (signed char)requant(v1, s_out);
    *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o) = q;
  } else if (out_kind == 1) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
  } else {
    __nv_bfloat162 h;
    h.x = __float2bfloat16_rn(v0);
    h.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) = h;
  }
}

// NT: n-tiles (8 channels each) per warp, Co = 16 * NT. KH: window (2 or 3).
template <int NT, int KH>
__global__ void __launch_bounds__(NTHREADS, 1)
conv_block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ k,
                  const float* __restrict__ ab, const int8_t* __restrict__ mask,
                  const int8_t* __restrict__ res, void* __restrict__ out,
                  int B, int H, int W, int C, int nph, int zpad, int out_kind) {
  constexpr int CO = 16 * NT;
  constexpr int WS = CO + 8;          // weight row stride, words
  constexpr int XR = TH + KH - 1;     // input tile rows
  constexpr int XC = TW + KH - 1;     // input tile columns
  const int C4 = C >> 2;
  const int XS = C4 + 4;              // input pixel stride, words

  extern __shared__ __align__(16) int32_t smem[];
  int32_t* ws = smem;                         // [KH*KH*C4][WS]
  int32_t* xs = smem + KH * KH * C4 * WS;     // [XR][XC][XS]
  __shared__ float s_alpha[CO], s_beta[CO];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;

  // the weight, once: word (tap, c4, co) = k[tap][4*c4 .. 4*c4+3][co]
  for (int idx = tid; idx < KH * KH * C4 * CO; idx += NTHREADS) {
    const int co = idx % CO, r = idx / CO;  // r = tap * C4 + c4
    const int tap = r / C4, c4 = r - tap * C4;
    const uint8_t* p = reinterpret_cast<const uint8_t*>(k) +
                       ((size_t)(tap * C + 4 * c4)) * CO + co;
    const uint32_t word = (uint32_t)p[0] | ((uint32_t)p[CO] << 8) |
                          ((uint32_t)p[2 * CO] << 16) |
                          ((uint32_t)p[3 * CO] << 24);
    ws[r * WS + co] = (int32_t)word;
  }
  for (int i = tid; i < CO; i += NTHREADS) {
    s_alpha[i] = ab[i];
    s_beta[i] = ab[CO + i];
  }
  const float s_out = ab[2 * CO], rs = ab[3 * CO], rsh = ab[4 * CO];
  const bool has_res = res != nullptr;
  const uint32_t padword = 0x01010101u * (uint32_t)(uint8_t)zpad;
  const uint4 padwords = make_uint4(padword, padword, padword, padword);
  const int C16 = C >> 4;
  const int cpp = CO / nph;  // channels per mask phase

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int n_tiles = B * tiles_y * tiles_x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int ty = (tile / tiles_x) % tiles_y, tx = tile % tiles_x;
    const int y0 = ty * TH, x0 = tx * TW;

    __syncthreads();  // the previous tile's reads of xs are done
    for (int idx = tid; idx < XR * XC * C16; idx += NTHREADS) {
      const int v = idx % C16, p = idx / C16;  // 16-byte vector v of pixel p
      const int j = p % XC, i = p / XC;
      const int iy = y0 - 1 + i, ix = x0 - 1 + j;
      uint4 words = padwords;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        words = *reinterpret_cast<const uint4*>(
            x + (((size_t)b * H + iy) * W + ix) * C + 16 * v);
      *reinterpret_cast<uint4*>(xs + p * XS + 4 * v) = words;
    }
    __syncthreads();

    int acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

#pragma unroll 1
    for (int tap = 0; tap < KH * KH; ++tap) {
      const int ky = tap / KH, kx = tap - ky * KH;
      const int32_t* wt = ws + tap * C4 * WS + wn * 8 * NT + g;
      const int32_t* xa0 = xs + ((2 * wm + ky) * XC + kx + g) * XS + t;
#pragma unroll 2
      for (int kc = 0; kc < C4; kc += 8) {  // 32 input channels per step
        int a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int32_t* xa = xa0 + mt * XC * XS + kc;
          a[mt][0] = xa[0];
          a[mt][1] = xa[8 * XS];
          a[mt][2] = xa[4];
          a[mt][3] = xa[8 * XS + 4];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int b0 = wt[(kc + t) * WS + nt * 8];
          const int b1 = wt[(kc + 4 + t) * WS + nt * 8];
          mma_s8(acc[0][nt], a[0], b0, b1);
          mma_s8(acc[1][nt], a[1], b0, b1);
        }
      }
    }

    // epilogue: acc[mt][nt][2*half + e] is pixel (2*wm + mt, g + 8*half),
    // channel wn*8*NT + nt*8 + 2*t + e
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int yy = y0 + 2 * wm + mt;
      if (yy >= H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int xx = x0 + g + 8 * half;
        if (xx >= W) continue;
        const size_t pix = ((size_t)b * H + yy) * W + xx;
        const int8_t* mrow = mask + pix * nph;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int co = wn * 8 * NT + nt * 8 + 2 * t;
          const float m = (float)mrow[co / cpp];  // co, co+1: the same phase
          int r0 = 0, r1 = 0;
          if (has_res) {
            const char2 rr =
                *reinterpret_cast<const char2*>(res + pix * CO + co);
            r0 = rr.x;
            r1 = rr.y;
          }
          const float v0 = epilogue(acc[mt][nt][2 * half], s_alpha[co],
                                    s_beta[co], has_res, r0, rs, rsh, m);
          const float v1 = epilogue(acc[mt][nt][2 * half + 1], s_alpha[co + 1],
                                    s_beta[co + 1], has_res, r1, rs, rsh, m);
          write_pair(out, pix * CO + co, out_kind, v0, v1, s_out);
        }
      }
    }
  }
}

template <int NT, int KH>
cudaError_t launch(const int8_t* x, const int8_t* k, const float* ab,
                   const int8_t* mask, const int8_t* res, void* out, int B,
                   int H, int W, int C, int nph, int zpad, int out_kind,
                   int smem, int device, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv_block_kernel<NT, KH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  const int blocks = (int)(n_tiles < sms ? n_tiles : sms);
  conv_block_kernel<NT, KH><<<blocks, NTHREADS, smem, stream>>>(
      x, k, ab, mask, res, out, B, H, W, C, nph, zpad, out_kind);
  return cudaGetLastError();
}

// The streamed variant. x has Hin rows per image and the tile's input row iy
// is read at row iy + row_off: (H, 0) for K1's operands, (H + kh - 1, 1) for
// K7's pre-padded input. The mask has nph bytes per pixel, each covering
// Co / nph channels (nph = Co: one byte per channel, K7's mask).
template <int NT, int KH>
__global__ void __launch_bounds__(rdt::NTHREADS, 2)
conv_stream_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ k,
                   const float* __restrict__ ab, const int8_t* __restrict__ mask,
                   const int8_t* __restrict__ res, void* __restrict__ out, int B,
                   int H, int W, int C, int Co, int nph, int Hin, int row_off,
                   int zpad, int out_kind, int kcw) {
  constexpr int COT = 16 * NT;
  extern __shared__ __align__(16) uint32_t smem_u[];
  const int n_cot = Co / COT;
  const int cot = blockIdx.x % n_cot, tile = blockIdx.x / n_cot;
  const int tiles_x = (W + rdt::TW - 1) / rdt::TW, tiles_y = (H + rdt::TH - 1) / rdt::TH;
  const int b = tile / (tiles_y * tiles_x);
  const int y0 = ((tile / tiles_x) % tiles_y) * rdt::TH, x0 = (tile % tiles_x) * rdt::TW;
  const int co0 = cot * COT;

  int acc[2][NT][4];
  rdt::conv_tile<rdt::S8, NT, KH>(acc, x, k, smem_u, b, y0, x0, co0, Hin, row_off, W, C,
                                  Co, kcw, 0x01010101u * (uint32_t)(uint8_t)zpad);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const float s_out = ab[2 * Co], rs = ab[3 * Co], rsh = ab[4 * Co];
  const bool has_res = res != nullptr;
  const int cpp = Co / nph;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int yy = y0 + 2 * wm + mt;
    if (yy >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xx = x0 + g + 8 * half;
      if (xx >= W) continue;
      const size_t pix = ((size_t)b * H + yy) * W + xx;
      const int8_t* mrow = mask + pix * nph;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + wn * 8 * NT + nt * 8 + 2 * t;
        const float m0 = (float)mrow[co / cpp], m1 = (float)mrow[(co + 1) / cpp];
        int r0 = 0, r1 = 0;
        if (has_res) {
          const char2 rr = *reinterpret_cast<const char2*>(res + pix * Co + co);
          r0 = rr.x;
          r1 = rr.y;
        }
        const float v0 = epilogue(acc[mt][nt][2 * half], __ldg(ab + co), __ldg(ab + Co + co),
                                  has_res, r0, rs, rsh, m0);
        const float v1 = epilogue(acc[mt][nt][2 * half + 1], __ldg(ab + co + 1),
                                  __ldg(ab + Co + co + 1), has_res, r1, rs, rsh, m1);
        write_pair(out, pix * Co + co, out_kind, v0, v1, s_out);
      }
    }
  }
}

template <int NT, int KH>
cudaError_t launch_stream(const int8_t* x, const int8_t* k, const float* ab,
                          const int8_t* mask, const int8_t* res, void* out, int B,
                          int H, int W, int C, int Co, int nph, int Hin, int row_off,
                          int zpad, int out_kind, cudaStream_t stream) {
  const int kcw = (C / 4) % 16 == 0 ? 16 : 8;
  const int smem = 4 * rdt::tile_smem_words(KH, kcw, 16 * NT);
  cudaError_t err = cudaFuncSetAttribute(
      conv_stream_kernel<NT, KH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((H + rdt::TH - 1) / rdt::TH) *
                           ((W + rdt::TW - 1) / rdt::TW) * (Co / (16 * NT));
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_stream_kernel<NT, KH><<<(int)blocks, rdt::NTHREADS, smem, stream>>>(
      x, k, ab, mask, res, out, B, H, W, C, Co, nph, Hin, row_off, zpad, out_kind, kcw);
  return cudaGetLastError();
}

// Co 16, 32, 64 or a multiple of 128 (tiled by 128)
cudaError_t dispatch_stream(const int8_t* x, const int8_t* k, const float* ab,
                            const int8_t* mask, const int8_t* res, void* out, int B,
                            int H, int W, int C, int Co, int kh, int nph, int Hin,
                            int row_off, int zpad, int out_kind, cudaStream_t st) {
#define RDT_STREAM(NT)                                                         \
  return kh == 3 ? launch_stream<NT, 3>(x, k, ab, mask, res, out, B, H, W, C,  \
                                        Co, nph, Hin, row_off, zpad, out_kind, \
                                        st)                                    \
                 : launch_stream<NT, 2>(x, k, ab, mask, res, out, B, H, W, C,  \
                                        Co, nph, Hin, row_off, zpad, out_kind, \
                                        st)
  if (Co == 16) RDT_STREAM(1);
  if (Co == 32) RDT_STREAM(2);
  if (Co == 64) RDT_STREAM(4);
  if (Co % 128 == 0) RDT_STREAM(8);
  return cudaErrorInvalidValue;
#undef RDT_STREAM
}

}  // namespace

// x (B, H, W, C) int8; k (kh, kh, C, Co) int8; ab (8, Co) float32, rows
// alpha, beta, s_out, rs, rsh; mask (B, H, W, nph) int8; res (B, H, W, Co)
// int8 or null; out (B, H, W, Co) int8 (out_kind 0), float32 (1) or bfloat16
// (2). x is 16-byte aligned, C % 32 == 0, kh in {2, 3}, nph divides Co.
// streamed 0: the resident variant, Co in {16, 32, 64, 128}, nph divides Co
// into an even number of channels, smem the dynamic shared memory the Python
// wrapper computed for these shapes (it checks them all). streamed 1: the
// streamed variant, Co in {16, 32, 64} or a multiple of 128, k 4-byte aligned.
extern "C" int rdt_conv_block(const void* x, const void* k, const void* ab,
                              const void* mask, const void* res, void* out,
                              int B, int H, int W, int C, int Co, int kh,
                              int nph, int zpad, int out_kind, int streamed,
                              int smem, int device, void* stream) {
  if (C % 32 != 0 || (kh != 2 && kh != 3) || nph <= 0 || Co % nph != 0 ||
      (!streamed && (Co / nph) % 2 != 0) || out_kind < 0 || out_kind > 2)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  auto xs = static_cast<const int8_t*>(x);
  auto ks = static_cast<const int8_t*>(k);
  auto abs_ = static_cast<const float*>(ab);
  auto ms = static_cast<const int8_t*>(mask);
  auto rs = static_cast<const int8_t*>(res);
  auto st = static_cast<cudaStream_t>(stream);
  if (streamed)
    return dispatch_stream(xs, ks, abs_, ms, rs, out, B, H, W, C, Co, kh, nph, H, 0,
                           zpad, out_kind, st);
#define RDT_LAUNCH(NT)                                                        \
  return kh == 3 ? launch<NT, 3>(xs, ks, abs_, ms, rs, out, B, H, W, C, nph,  \
                                 zpad, out_kind, smem, device, st)            \
                 : launch<NT, 2>(xs, ks, abs_, ms, rs, out, B, H, W, C, nph,  \
                                 zpad, out_kind, smem, device, st)
  switch (Co) {
    case 16: RDT_LAUNCH(1);
    case 32: RDT_LAUNCH(2);
    case 64: RDT_LAUNCH(4);
    case 128: RDT_LAUNCH(8);
    default: return cudaErrorInvalidValue;
  }
#undef RDT_LAUNCH
}

// K7. xp (B, H + kh - 1, W, C) int8: the input padded in H by the caller with
// (1, kh - 2) rows of zpad; k (kh, kh, C, Co) int8; ab (8, Co) float32 as
// above; mask (B, H, W, Co) int8, one byte per output channel; res (B, H, W,
// Co) int8 or null; out (B, H, W, Co) int8. xp is 16-byte aligned, k 4-byte
// aligned, C % 32 == 0, Co in {16, 32, 64} or a multiple of 128.
extern "C" int rdt_chain_conv(const void* xp, const void* k, const void* ab,
                              const void* mask, const void* res, void* out,
                              int B, int H, int W, int C, int Co, int kh,
                              int zpad, int device, void* stream) {
  if (C % 32 != 0 || (kh != 2 && kh != 3)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  return dispatch_stream(static_cast<const int8_t*>(xp), static_cast<const int8_t*>(k),
                         static_cast<const float*>(ab), static_cast<const int8_t*>(mask),
                         static_cast<const int8_t*>(res), out, B, H, W, C, Co, kh,
                         /*nph=*/Co, /*Hin=*/H + kh - 1, /*row_off=*/1, zpad,
                         /*out_kind=*/0, static_cast<cudaStream_t>(stream));
}
