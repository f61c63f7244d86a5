// The tiled tensor-core convolution shared by the streamed int8 link (K1's
// wide variant and K7, csrc/conv_block.cu) and the bfloat16 link (K6 and K9,
// csrc/conv_block_fp.cu).
//
// One block computes an output tile of 8 x 16 pixels by COT = 16 * NT output
// channels of a stride-1 convolution with a 3x3 window padded (1, 1) or a 2x2
// window padded (1, 0). It walks over the input channels in chunks of `kcw`
// 32-bit words (a word is 4 int8 or 2 bfloat16 channels; kcw is 8 or 16):
// per chunk it stages the weight slice [tap][kcw][COT] and the input tile
// with its halo [rows][cols][kcw] in shared memory, then every tap issues
// mma.sync on fragments read straight from shared memory. The whole weight
// never has to fit: (3, 3, 256, 256), (2, 2, 512, 256) and (2, 2, 1024, 256)
// stream through 78 KB. Accumulators stay in registers across the chunks.
//
// The weight arrives in its natural (kh, kw, C, Co) layout. A B fragment
// wants words of consecutive input channels of one output channel, so the
// loader reads 4 (int8) or 2 (bfloat16) rows of 4 output channels and
// transposes them in registers with byte permutes into four words.
//
// Row strides in shared memory (COT + 8 words for the weight, kcw + 4 words
// per input pixel) keep the fragment loads free of bank conflicts.
//
// The input may be addressed in two ways: as it is (rows outside [0, H) read
// the padding word), or pre-padded in H by the caller (row_off = 1, Hin = the
// padded height), which is the first-generation chain kernel's contract.
// Columns outside [0, W) always read the padding word.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rdt {

constexpr int TH = 8;    // tile rows
constexpr int TW = 16;   // tile columns (the m of one mma)
constexpr int NTHREADS = 256;

struct S8 {
  using elem = int8_t;
  using acc_t = int;
  static constexpr int CPW = 4;  // channels per 32-bit word
  static __device__ __forceinline__ void mma(acc_t (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // p: weight element (c, co) with c, co multiples of 4; row: elements per
  // weight row (Co). Word j of the result holds channels c..c+3 of output
  // channel co + j.
  static __device__ __forceinline__ uint4 pack4(const elem* p, size_t row) {
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + row);
    const uint32_t r2 = *reinterpret_cast<const uint32_t*>(p + 2 * row);
    const uint32_t r3 = *reinterpret_cast<const uint32_t*>(p + 3 * row);
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
    return make_uint4(__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                      __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632));
  }
};

struct BF16 {
  using elem = __nv_bfloat16;
  using acc_t = float;
  static constexpr int CPW = 2;
  static __device__ __forceinline__ void mma(acc_t (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // p: weight element (c, co) with c even and co a multiple of 4. Word j
  // holds channels c, c+1 of output channel co + j.
  static __device__ __forceinline__ uint4 pack4(const elem* p, size_t row) {
    const uint2 r0 = *reinterpret_cast<const uint2*>(p);
    const uint2 r1 = *reinterpret_cast<const uint2*>(p + row);
    return make_uint4(__byte_perm(r0.x, r1.x, 0x5410), __byte_perm(r0.x, r1.x, 0x7632),
                      __byte_perm(r0.y, r1.y, 0x5410), __byte_perm(r0.y, r1.y, 0x7632));
  }
};

// 32-bit words of dynamic shared memory one block needs
__host__ __device__ constexpr int tile_smem_words(int kh, int kcw, int cot) {
  return kh * kh * kcw * (cot + 8) + (TH + kh - 1) * (TW + kh - 1) * (kcw + 4);
}

// Accumulate the tile at batch b, rows y0.., columns x0.., output channels
// co0..co0+COT-1 into acc. Afterwards acc[mt][nt][2*half + e] is the pixel
// (y0 + 2*wm + mt, x0 + g + 8*half) and the channel
// co0 + wn*8*NT + nt*8 + 2*t + e, with lane = 4*g + t, warp = wm + 4*wn.
// Every thread of the block must call it (it synchronizes). With SHIFT false
// every tap reads the window's centre column of its first row (no shifted
// views): the conv probe's "dots" mode, nine products of one pixel.
template <class T, int NT, int KH, bool SHIFT = true>
__device__ __forceinline__ void conv_tile(
    typename T::acc_t (&acc)[2][NT][4], const typename T::elem* __restrict__ x,
    const typename T::elem* __restrict__ k, uint32_t* smem, int b, int y0, int x0,
    int co0, int Hin, int row_off, int W, int C, int Co, int kcw, uint32_t padword) {
  constexpr int COT = 16 * NT;
  constexpr int WS = COT + 8;          // weight row stride, words
  constexpr int XR = TH + KH - 1;      // input tile rows
  constexpr int XC = TW + KH - 1;      // input tile columns
  constexpr int CO4 = COT / 4;
  const int XS = kcw + 4;              // input pixel stride, words
  const int CW = C / T::CPW;           // words per input pixel
  uint32_t* ws = smem;                 // [KH*KH][kcw][WS]
  uint32_t* xs = smem + KH * KH * kcw * WS;  // [XR][XC][XS]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const uint4 padwords = make_uint4(padword, padword, padword, padword);

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int V = kcw >> 2;  // 16-byte vectors per pixel and chunk
#pragma unroll 1
  for (int cw0 = 0; cw0 < CW; cw0 += kcw) {
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tid; idx < KH * KH * kcw * CO4; idx += NTHREADS) {
      const int co4 = idx % CO4, r = idx / CO4;  // r = tap * kcw + word
      const int tap = r / kcw, w = r - tap * kcw;
      const typename T::elem* p =
          k + ((size_t)tap * C + (size_t)(cw0 + w) * T::CPW) * Co + co0 + 4 * co4;
      *reinterpret_cast<uint4*>(ws + r * WS + 4 * co4) = T::pack4(p, (size_t)Co);
    }
    for (int idx = tid; idx < XR * XC * V; idx += NTHREADS) {
      const int v = idx % V, p = idx / V;
      const int j = p % XC, i = p / XC;
      const int iy = y0 - 1 + i + row_off, ix = x0 - 1 + j;
      uint4 words = padwords;
      if (iy >= 0 && iy < Hin && ix >= 0 && ix < W)
        words = *reinterpret_cast<const uint4*>(
            reinterpret_cast<const uint32_t*>(x + (((size_t)b * Hin + iy) * W + ix) * C) +
            cw0 + 4 * v);
      *reinterpret_cast<uint4*>(xs + p * XS + 4 * v) = words;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < KH * KH; ++tap) {
      const int ky = SHIFT ? tap / KH : 0, kx = SHIFT ? tap - ky * KH : 1;
      const uint32_t* wt = ws + tap * kcw * WS + wn * 8 * NT + g;
      const uint32_t* xa0 = xs + ((2 * wm + ky) * XC + kx + g) * XS + t;
#pragma unroll 2
      for (int kc = 0; kc < kcw; kc += 8) {  // one mma k-step: 8 words
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* xa = xa0 + mt * XC * XS + kc;
          a[mt][0] = xa[0];
          a[mt][1] = xa[8 * XS];
          a[mt][2] = xa[4];
          a[mt][3] = xa[8 * XS + 4];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t b0 = wt[(kc + t) * WS + nt * 8];
          const uint32_t b1 = wt[(kc + 4 + t) * WS + nt * 8];
          T::mma(acc[0][nt], a[0], b0, b1);
          T::mma(acc[1][nt], a[1], b0, b1);
        }
      }
    }
  }
}

}  // namespace rdt
