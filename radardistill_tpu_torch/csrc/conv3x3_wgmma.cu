// The Hopper conv mainloop: TMA loads into mbarrier rings, wgmma from shared
// memory, a persistent grid. Four kernels of the port run on it:
//
//   K1  ops/conv_block.py::conv_block (the wgmma route, replaces
//       radardistill_tpu/ops/pallas_conv_block.py::_block_kernel in int8
//       mode): the teacher's fused int8 conv link, a 3x3 window padded (1, 1)
//       or a 2x2 window padded (1, 0), int8 x int8 -> int32, then the link's
//       epilogue (affine, int8 residual, relu, compact phase mask, requant to
//       int8 or the float value as bfloat16); padding cells hold zpad;
//   K6  ops/conv_block.py::conv_block_fp (the wgmma route, replaces
//       radardistill_tpu/ops/pallas_conv_block.py::_block_kernel in bf16
//       mode): the teacher's fused bfloat16 conv link, the same two windows,
//       float32 accumulation, then its epilogue (affine, bfloat16 residual
//       added as float32, relu, compact phase mask, one rounding to
//       bfloat16); padding cells hold zeros;
//   K9  ops/wide_conv.py::conv3x3_wide, bfloat16 y and dx (replaces
//       radardistill_tpu/ops/pallas_wide_conv.py::_wide_kernel): the 3x3
//       stride-1 pad-1 conv of x (B, H, W, C), float32 accumulation,
//       bfloat16 out;
//   P1  ops/probes.py::conv_probe(route="wgmma") (replaces the kernels of
//       tools/pallas_conv_proto.py): conv, dots and int8 on an input that is
//       pre-padded by one zero row above and below, xp (B, H + 2, W, C);
//   K7  ops/int8_conv.py::chain_conv (the wgmma route, replaces
//       radardistill_tpu/ops/pallas_int8_conv.py::_chain_kernel): K1's link
//       on the first generation's operands, an input pre-padded in H with
//       zpad rows, xp (B, H + kh - 1, W, C), and a mask of one byte per
//       output channel, (B, H, W, Co). The mainloop reads the interior rows
//       xp[:, 1 : 1 + H] through a 4-d TMA map whose image stride is that of
//       xp (H + kh - 1 rows), so the zpad rows are never read: TMA's zero
//       fill and K1's border correction (below) stand for them, exactly.
//       Its Co-64 links (stage 2 under CONV_BLOCK_V1=1) take the transposed
//       conv_co64_kernel below, as K1's do, with the same strided map.
//
// The weight arrives K-major, wk (kh * kh, Co, C): tap t's (Co, C) slice. For
// dx the caller passes the forward's (3, 3, Co_f, C_f) kernel as it lies,
// which is (9, N, K) of the dx conv with the taps reversed (`flip`).
//
// What bounds it: operations (2 * kh * kh * C * Co per pixel against about
// C + Co bytes in int8, 2 * (C + Co) in bfloat16), so the design feeds the
// tensor cores and hides every copy:
//
// - A CTA of three warpgroups owns 4 x 64 output pixels by 128 output
//   channels. Warpgroup 0 is the producer: one thread issues the TMA loads
//   and the warpgroup gives its registers away (setmaxnreg). Warpgroups 1 and
//   2 consume: each holds two m64 x n128 float32 (or int32) accumulators, two
//   output rows of 64 pixels.
// - Per chunk of 128 bytes of input channels (64 bfloat16, 128 int8) one TMA
//   box brings the tile with its halo, 6 rows x 66 pixels starting at (y0 -
//   1, x0 - 1), in the 128-byte swizzle; the zero fill of out-of-bounds boxes
//   is the conv's padding (K1's and K9's rows -1 and H, every input's columns
//   -1 and W; P1's rows come pre-padded). A tap's A operand is a VIEW of that
//   tile: output row r, tap (ky, kx) starts (r + ky) * 66 + kx rows into it,
//   8-row groups 1024 bytes apart; the descriptor's base-offset field stays 0
//   (the tensor core swizzles by the address bits it reads, as TMA stored
//   them; measured on an H100, see wgmma_ops.cuh). One staged halo serves all
//   taps; a 2x2 tap reads rows y - 1, y and columns x - 1, x, which the same
//   box and the same view rule cover.
// - Per (chunk, tap) one TMA box brings the weight slice, 128 output channels
//   x 128 bytes, K-major in the same swizzle: 16 KB of weight per 256 pixels,
//   a quarter of the L2 weight traffic per operation of a 64-pixel tile.
// - Two rings: halo tiles (2 stages of 50 KB) and weight slices (5 stages of
//   16 KB), each stage with a full barrier (TMA's transaction count) and an
//   empty barrier (one arrival per consumer warpgroup). A consumer issues the
//   eight products of a tap (4 K steps x 2 tiles), commits them as one group
//   and waits with depth 1, so one group is always in flight while it
//   releases the slices of the previous one.
// - The grid is persistent, one CTA per SM walking the tiles, output
//   channels fastest; the producer runs ahead into the next tile while the
//   consumers store this one.
// - Epilogue: float32 -> bfloat16 round-to-nearest-even (K9, conv, dots), P1's
//   int8 requant, K1's link or K6's; every float operation rounds once, as
//   the plain versions' do (__fmul_rn, __fadd_rn, rintf). Each warp stages
//   its 16 pixels x 128 bytes of output in shared memory and stores them as
//   16-byte vectors (a bfloat16 link output in passes of 64 channels).
//
// K1's border: TMA fills out-of-bounds cells only with zeros, but K1's padding
// cells hold zpad = -zero (0, or -127 after a relu: the code that dequantizes
// to 0). Pre-padding the input would cost a read and a write of it; instead
// the epilogue corrects the exact int32 accumulator of the pixels next to the
// image's edge, acc += zpad * sum of wsum[t][co] over the taps t that fall
// outside the image, wsum (kh * kh, Co) the weight summed over C. Only tiles
// that touch an edge pay for it; per padding tap a thread reads its 32
// channels of wsum together (one dependent read per channel and tap doubled
// the link's time: measured on an H100). The residual tile (16 pixels x 128
// int8 channels a warp) arrives with 16-byte loads into bytes 128-255 of the
// warp's staging rows, beside the output's 128 bytes; it and the mask bytes
// are prefetched into L2 when the tile starts. K1's epilogue is long beside a
// tile's products at C = 128, so its two consumers run a few weight slices
// apart, each one's epilogue beside the other's products (3-5% measured).
//
// K6 takes the same pieces in bfloat16: TMA's zero fill is its padding (no
// border correction), its residual (64 bfloat16 channels, 128 bytes a pixel,
// per pass) is staged in bytes 128-255 of the staging rows beside the pass's
// 128 bytes of output, and its consumers run apart as K1's do. K1 and K6 read
// each tile's mask bytes into registers, and alpha and beta of its channels
// into a shared copy per consumer, when the tile starts, so that those reads
// land while the products run (read after them, they stood exposed after
// each tile's products). K6's, K1's and K7's Co-64 links take their own
// kernel below, conv_co64_kernel, with the product transposed.
//
// K7's mask (a byte per output channel, int8 out) is not a word per pixel:
// its epilogue (EPI_K7, K1's otherwise) has each lane load its part of the
// warp's 16 pixels x 128 mask bytes of both output rows as 16-byte vectors
// (8 a lane) when the tile starts, so that they land while the products
// run, as K1's mask words do; the epilogue stages a row's vectors in bytes
// 0-127 of the warp's staging rows, beside the residual, and each thread
// reads its two channels' bytes there before it writes their output codes in
// their place. The transposed kernel takes K7's mask another way (below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma_ops.cuh"
#include "wgmma_ops.cuh"

namespace {

constexpr int TH = 4, TW = 64, BN = 128;  // output tile: TH x TW pixels x BN channels
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int ROW = 128;                               // bytes of channels per staged pixel
constexpr int A_BYTES = HALO_H * HALO_W * ROW;         // one halo tile, 50 688 bytes
constexpr int A_STAGE = (A_BYTES + 1023) / 1024 * 1024;
constexpr int B_BYTES = BN * ROW;                      // one weight slice
constexpr int A_STAGES = 2, B_STAGES = 5;
constexpr int EPI_ROW = 2 * BN + 16;                   // padded: conflict-free fragment stores
constexpr int EPI_WARP = 16 * EPI_ROW;
constexpr int AB_BYTES = 2 * 2 * BN * 4;               // each consumer's alpha, beta
constexpr int THREADS = 384;
constexpr int SMEM = 1024 + A_STAGES * A_STAGE + B_STAGES * B_BYTES + 8 * EPI_WARP + AB_BYTES +
                     2 * 8 * (A_STAGES + B_STAGES);
// K1's and K6's consumers run this many weight slices apart: fewer than the
// ring holds, and the taps of one 2x2 chunk, so that consumer 0 needs one halo
// stage to get there
constexpr int STAGGER = 4;
static_assert(STAGGER < B_STAGES && SMEM <= 232448, "the rings, the stagger and the epilogue fit");

struct Bf16 {
  using acc_t = float;
  static constexpr int ES = 2;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da, uint64_t db) {
    rdt::wgmma_bf16_n128(d, da, db);
  }
};
struct S8 {
  using acc_t = int;
  static constexpr int ES = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da, uint64_t db) {
    rdt::wgmma_s8_n128(d, da, db);
  }
};

// the epilogues: bfloat16 out (K9, P1 conv and dots), P1's int8 requant, K1's
// link with an int8 or a bfloat16 output, K6's link, K1's int8 link with K7's
// mask of a byte per output channel
enum Epi { EPI_BF16, EPI_P1, EPI_K1_S8, EPI_K1_BF16, EPI_K6, EPI_K7 };

struct EpiArgs {
  const float* scale;   // P1: (Co,) requant scale
  int relu;             // P1
  const float* ab;      // K1: (8, Co), rows alpha, beta, s_out, rs, rsh; K6: (2, Co)
  const int8_t* mask;   // K1, K6: (B, H, W, nph); K7: (B, H, W, Co)
  const int8_t* res;    // K1: (B, H, W, Co) or null
  const __nv_bfloat16* res16;  // K6: (B, H, W, Co) or null
  const int* wsum;      // K1: (kh * kh, Co), the weight summed over C per tap
  int nph, zpad;        // K1 (nph also K6)
};

// keeps the compiler from moving reads of the accumulators above the wait
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// P1's int8 epilogue, the mma.sync route's (csrc/conv_probe.cu): every float
// operation rounds once, as the plain version's does
__device__ __forceinline__ signed char quantize(int acc, float a, int relu) {
  float y = __fmul_rn((float)acc, a);
  if (relu) y = fmaxf(y, 0.0f);
  const float v = __fsub_rn(rintf(__fmul_rn(y, 0.37f)), 127.0f);
  return (signed char)fminf(fmaxf(v, -127.0f), 127.0f);
}

// K1's epilogue on one accumulator, csrc/conv_block.cu's: every float
// operation rounds once
__device__ __forceinline__ float link_value(int acc, float alpha, float beta, bool has_res, int r,
                                            float rs, float rsh, float m) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), alpha), beta);
  if (has_res) y = __fadd_rn(y, __fadd_rn(__fmul_rn(__int2float_rn(r), rs), rsh));
  y = fmaxf(y, 0.0f);
  return __fmul_rn(y, m);
}

// K6's epilogue on one accumulator, csrc/conv_block_fp.cu's: every float
// operation rounds once
__device__ __forceinline__ float fp_value(float acc, float alpha, float beta, bool has_res,
                                          float r, float m) {
  float y = __fadd_rn(__fmul_rn(acc, alpha), beta);
  if (has_res) y = __fadd_rn(y, r);
  y = fmaxf(y, 0.0f);
  return __fmul_rn(y, m);
}

// clip(rint(y * s_out) - 127, -127, 127): the conversion rounds half to even
// (a NaN converts to 0, as the clip of the float form takes it to -127)
__device__ __forceinline__ signed char requant(float y, float s_out) {
  return (signed char)(min(max(__float2int_rn(__fmul_rn(y, s_out)), 0), 254) - 127);
}

// named barrier 2 + cw among the 128 threads of consumer warpgroup cw
__device__ __forceinline__ void consumer_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
}

// named barrier 1 among the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
__device__ __forceinline__ void consumers_arrive() {
  asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// 16 bytes from device memory into shared memory, asynchronously, past L1
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's copies have landed; a barrier then shows them to the others
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the taps (bit ky * kh + kx) of output pixel (yy, xx) that read a cell
// outside the image: tap (ky, kx) reads (yy + ky - 1, xx + kx - 1)
__device__ __forceinline__ unsigned outside_taps(int yy, int xx, int H, int W, int kh) {
  unsigned bad = 0;
  for (int ky = 0; ky < kh; ++ky)
    for (int kx = 0; kx < kh; ++kx) {
      const int iy = yy + ky - 1, ix = xx + kx - 1;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) bad |= 1u << (ky * kh + kx);
    }
  return bad;
}

struct Tile {
  int b, y0, x0, co0;
};

__device__ __forceinline__ Tile tile_of(int id, int H, int W, int Co) {
  const int n_co = Co / BN, tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int s = id / n_co;
  return {s / (tiles_x * tiles_y), ((s / tiles_x) % tiles_y) * TH, (s % tiles_x) * TW,
          (id % n_co) * BN};
}

// tmx: the activation (B, Hin, W, C) as a 4-d map, box (ROW / ES, HALO_W,
// HALO_H, 1); tmw: the weight (kh * kh, Co, C) as a 3-d map, box (ROW / ES,
// BN, 1). row_off: the input row of output row 0's tap ky = 0 (-1 unpadded, 0
// for a pre-padded input). shift: conv (1) or dots (0, every tap reads the
// centre column of halo row r).
template <class T, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                  uint8_t* __restrict__ out, const EpiArgs ep, int B, int H, int W, int C, int Co,
                  int kh, int row_off, int shift, int flip) {
  using acc_t = typename T::acc_t;
  constexpr int CH = ROW / T::ES;  // channels per chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~(uintptr_t)1023);
  uint8_t* sb = sa + A_STAGES * A_STAGE;
  uint8_t* se = sb + B_STAGES * B_BYTES;
  float* sab_all = reinterpret_cast<float*>(se + 8 * EPI_WARP);
  uint64_t* full_a = reinterpret_cast<uint64_t*>(se + 8 * EPI_WARP + AB_BYTES);
  uint64_t* empty_a = full_a + A_STAGES;
  uint64_t* full_b = empty_a + A_STAGES;
  uint64_t* empty_b = full_b + B_STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      rdt::mbar_init(full_a + s, 1);
      rdt::mbar_init(empty_a + s, 2);
    }
    for (int s = 0; s < B_STAGES; ++s) {
      rdt::mbar_init(full_b + s, 1);
      rdt::mbar_init(empty_b + s, 2);
    }
    rdt::mbar_init_fence();
  }
  __syncthreads();

  const int n_tiles = B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (Co / BN);
  const int chunks = C / CH, taps = kh * kh;

  if (wg == 0) {  // ------------------------------------------------ producer
    rdt::setmaxnreg_dec<40>();
    if (tid != 0) return;
    rdt::tma_prefetch_desc(&tmx);
    rdt::tma_prefetch_desc(&tmw);
    int ia = 0, pa = 0, ib = 0, pb = 0;
    for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
      const Tile tl = tile_of(id, H, W, Co);
      for (int c = 0; c < chunks; ++c) {
        rdt::mbar_wait(empty_a + ia, pa ^ 1);
        rdt::mbar_arrive_expect_tx(full_a + ia, A_BYTES);
        rdt::tma_load_4d(sa + ia * A_STAGE, &tmx, full_a + ia, c * CH, tl.x0 - 1, tl.y0 + row_off,
                         tl.b);
        if (++ia == A_STAGES) ia = 0, pa ^= 1;
        for (int t = 0; t < taps; ++t) {
          rdt::mbar_wait(empty_b + ib, pb ^ 1);
          rdt::mbar_arrive_expect_tx(full_b + ib, B_BYTES);
          rdt::tma_load_3d(sb + ib * B_BYTES, &tmw, full_b + ib, c * CH, tl.co0,
                           flip ? taps - 1 - t : t);
          if (++ib == B_STAGES) ib = 0, pb ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  rdt::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // output rows 2 cw and 2 cw + 1 of the tile
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  uint8_t* ebuf = se + (cw * 4 + warp) * EPI_WARP;
  const uint32_t sa_addr = rdt::smem_addr(sa), sb_addr = rdt::smem_addr(sb);
  acc_t acc[2][64];
  int ia = 0, pa = 0, ib = 0, pb = 0;
  // K1 and K6: consumer 1 starts STAGGER weight slices behind consumer 0 and
  // the rings keep them apart (a consumer can run at most B_STAGES - 1
  // slices ahead of the other), so each one's epilogue runs while the other
  // issues products: the epilogue is long beside a tile's products
  constexpr bool K6 = EPI == EPI_K6;
  constexpr bool LANE = EPI == EPI_K7;  // a mask byte per output channel
  constexpr bool LINK = EPI == EPI_K1_S8 || EPI == EPI_K1_BF16 || K6 || LANE;
  int lead = LINK && cw == 0 ? STAGGER : 0;
  float* sab = sab_all + cw * 2 * BN;  // this consumer's alpha (BN), beta (BN)
  int sab_co0 = -1;
  if (LINK && cw == 1) consumers_sync();

  for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
    const Tile tl = tile_of(id, H, W, Co);
    if constexpr (LINK) {
      // the epilogue's reads from device memory start now, into L2, and
      // land while the products run: lane (j, r) of a warp brings pixel
      // x0 + 16 warp + r of output row 2 cw + j, its BN channels of
      // residual (128 bytes a line) and the mask bytes of the warp's 16
      // pixels
      const int j = lane >> 4, r = lane & 15;
      const int yy = tl.y0 + 2 * cw + j, xx = tl.x0 + 16 * warp + r;
      if (yy < H && xx < W) {
        const size_t pix = ((size_t)tl.b * H + yy) * W + xx;
        if constexpr (K6) {
          if (ep.res16 != nullptr)
#pragma unroll
            for (int c = 0; c < BN; c += 64) prefetch_l2(ep.res16 + pix * Co + tl.co0 + c);
        } else if (ep.res != nullptr) {
          prefetch_l2(ep.res + pix * Co + tl.co0);
        }
        if (!LANE && (r == 0 || r == 15)) prefetch_l2(ep.mask + pix * ep.nph);
      }
    }
    // the link's mask bytes for the thread's four pixels and alpha, beta of
    // the tile's channels (into this consumer's shared copy, when the tile's
    // channels differ from the last tile's), read now: they land while the
    // products run
    uint32_t mw[2][2] = {{0u, 0u}, {0u, 0u}};
    // K7's mask: mv[j][i] of lane l is 16-byte unit l & 7 of pixel x0 + 16
    // warp + (l >> 3) + 4 i of output row 2 cw + j
    uint4 mv[2][4];
    if constexpr (LANE) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int yy = tl.y0 + 2 * cw + j, xx = tl.x0 + 16 * warp + (lane >> 3) + 4 * i;
          mv[j][i] = make_uint4(0, 0, 0, 0);
          if (yy < H && xx < W)
            mv[j][i] = __ldg(reinterpret_cast<const uint4*>(
                ep.mask + (((size_t)tl.b * H + yy) * W + xx) * Co + tl.co0 + 16 * (lane & 7)));
        }
    }
    if constexpr (LINK) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int yy = tl.y0 + 2 * cw + j, xx = tl.x0 + 16 * warp + g + 8 * h;
          if (!LANE && yy < H && xx < W) {
            const int8_t* mp = ep.mask + (((size_t)tl.b * H + yy) * W + xx) * ep.nph;
            mw[j][h] = ep.nph == 4   ? __ldg(reinterpret_cast<const uint32_t*>(mp))
                       : ep.nph == 2 ? (uint32_t)__ldg(reinterpret_cast<const uint16_t*>(mp))
                                     : (uint32_t)(uint8_t)__ldg(mp);
          }
        }
      if (tl.co0 != sab_co0) {  // the same for every thread of the CTA
        consumer_sync(cw);  // no warp of this consumer still reads the old values
        for (int i = tid; i < 2 * BN; i += 128)
          sab[i] = __ldg(ep.ab + (i >= BN ? Co : 0) + tl.co0 + (i & (BN - 1)));
        consumer_sync(cw);
        sab_co0 = tl.co0;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0;
    int prev_a = -1, prev_b = -1;  // slots whose last products may still run

#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
      rdt::mbar_wait(full_a + ia, pa);
      const uint32_t a_base = sa_addr + ia * A_STAGE + 2 * cw * HALO_W * ROW;
#pragma unroll 1
      for (int t = 0; t < taps; ++t) {
        rdt::mbar_wait(full_b + ib, pb);
        const int ky = shift ? t / kh : 0, kx = shift ? t - (t / kh) * kh : 1;
        const uint32_t a_tap = a_base + (ky * HALO_W + kx) * ROW;
        const uint32_t b_tap = sb_addr + ib * B_BYTES;
        rdt::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < ROW; ks += 32) {  // one instruction: 32 bytes of K
          const uint64_t db = rdt::wgmma_desc_sw128(b_tap + ks);
          T::mma(acc[0], rdt::wgmma_desc_sw128_rows(a_tap + ks, 1024), db);
          T::mma(acc[1], rdt::wgmma_desc_sw128_rows(a_tap + HALO_W * ROW + ks, 1024), db);
        }
        rdt::wgmma_commit();
        rdt::wgmma_wait<1>();  // the previous tap's products are done
        if (prev_b >= 0 && tid == 0) rdt::mbar_arrive(empty_b + prev_b);
        prev_b = ib;
        if (t == 0 && prev_a >= 0) {  // ... and with them the previous chunk's
          if (tid == 0) rdt::mbar_arrive(empty_a + prev_a);
          prev_a = -1;
        }
        if (++ib == B_STAGES) ib = 0, pb ^= 1;
        if (lead > 0 && --lead == 0) consumers_arrive();
      }
      prev_a = ia;
      if (++ia == A_STAGES) ia = 0, pa ^= 1;
    }
    rdt::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) fence_operand(acc[j][i]);
    if (tid == 0) {
      rdt::mbar_arrive(empty_b + prev_b);
      rdt::mbar_arrive(empty_a + prev_a);
    }

    // epilogue: thread (warp, 4 g + tq) holds rows 16 warp + g (+ 8) of each
    // m64 tile, channels 8 n + 2 tq (+ 1); row m is pixel x0 + m
    if constexpr (EPI == EPI_BF16 || EPI == EPI_P1) {
      constexpr int ROW_OUT = BN * T::ES, VECS = ROW_OUT / 16;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint8_t* dst = ebuf + (g + 8 * h) * EPI_ROW;
#pragma unroll
          for (int n = 0; n < BN / 8; ++n) {
            const int col = 8 * n + 2 * tq;
            if constexpr (EPI == EPI_BF16) {
              __nv_bfloat162 v;
              v.x = __float2bfloat16_rn(acc[j][4 * n + 2 * h]);
              v.y = __float2bfloat16_rn(acc[j][4 * n + 2 * h + 1]);
              *reinterpret_cast<__nv_bfloat162*>(dst + 2 * col) = v;
            } else {
              *reinterpret_cast<char2*>(dst + col) = make_char2(
                  quantize(acc[j][4 * n + 2 * h], __ldg(ep.scale + tl.co0 + col), ep.relu),
                  quantize(acc[j][4 * n + 2 * h + 1], __ldg(ep.scale + tl.co0 + col + 1),
                           ep.relu));
            }
          }
        }
        __syncwarp();
        const int yy = tl.y0 + 2 * cw + j;
        for (int v = lane; v < 16 * VECS; v += 32) {
          const int r = v / VECS, u = v % VECS;
          const int xx = tl.x0 + 16 * warp + r;
          if (yy < H && xx < W)
            *reinterpret_cast<uint4*>(out + ((((size_t)tl.b * H + yy) * W + xx) * Co + tl.co0) *
                                                T::ES + 16 * u) =
                *reinterpret_cast<const uint4*>(ebuf + r * EPI_ROW + 16 * u);
        }
        __syncwarp();
      }
    } else {  // ------------------------------------------ K1's and K6's link
      constexpr bool S8_OUT = EPI == EPI_K1_S8 || LANE;
      // passes of 128 bytes of output: one of 128 int8 channels, or of 64
      // bfloat16 channels each
      constexpr int ES_OUT = S8_OUT ? 1 : 2, PASSES = BN * ES_OUT / 128, NP = BN / 8 / PASSES;
      float s_out = 0.0f, rs = 0.0f, rsh = 0.0f;
      if constexpr (!K6) {
        s_out = __ldg(ep.ab + 2 * Co), rs = __ldg(ep.ab + 3 * Co), rsh = __ldg(ep.ab + 4 * Co);
      }
      const bool has_res = K6 ? ep.res16 != nullptr : ep.res != nullptr;
      // K1's border correction, in the exact int32 accumulator: per padding
      // tap of the pixel, the thread's 32 channels of wsum, read together
      // (K6 pads with zeros: TMA's fill is exact)
      if constexpr (!K6) {
        if (ep.zpad != 0 &&
            (tl.y0 == 0 || tl.x0 == 0 || tl.y0 + TH >= H || tl.x0 + TW >= W)) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int yy = tl.y0 + 2 * cw + j, xx = tl.x0 + 16 * warp + g + 8 * h;
              const unsigned bad = yy < H && xx < W ? outside_taps(yy, xx, H, W, kh) : 0u;
              for (unsigned bb = bad; bb; bb &= bb - 1) {
                const int* ws = ep.wsum + (__ffs((int)bb) - 1) * Co + tl.co0 + 2 * tq;
#pragma unroll
                for (int n0 = 0; n0 < BN / 8; n0 += 8) {
                  int2 w[8];
#pragma unroll
                  for (int n = 0; n < 8; ++n)
                    w[n] = __ldg(reinterpret_cast<const int2*>(ws + 8 * (n0 + n)));
#pragma unroll
                  for (int n = 0; n < 8; ++n) {
                    acc[j][4 * (n0 + n) + 2 * h] += ep.zpad * w[n].x;
                    acc[j][4 * (n0 + n) + 2 * h + 1] += ep.zpad * w[n].y;
                  }
                }
              }
            }
        }
      }
      // the mask phase of channel co0 + 8 n + 2 tq, two bits per n (nph is
      // 1, 2 or 4 and Co / nph a multiple of 8, so a phase changes only
      // between two n)
      const int cpp = Co / ep.nph;
      uint32_t phases = 0;
      for (int n = 0, ph = tl.co0 / cpp, left = cpp - tl.co0 % cpp; !LANE && n < BN / 8; ++n) {
        phases |= (uint32_t)ph << (2 * n);
        if ((left -= 8) == 0) ++ph, left = cpp;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int yy = tl.y0 + 2 * cw + j;
        const size_t row_pix = ((size_t)tl.b * H + yy) * W + tl.x0 + 16 * warp;
        // the warp's 16 pixels x 128 bytes of residual into bytes 128-255 of
        // its staging rows: K1's 128 int8 channels once per row, K6's 64
        // bfloat16 channels of pass p at the start of that pass; K7's 128
        // mask bytes (read when the tile started) into bytes 0-127
        auto load_res = [&](uint4 (&rv)[4], const uint8_t* src, size_t pix_bytes) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = (lane >> 3) + 4 * i, u = lane & 7;
            rv[i] = make_uint4(0, 0, 0, 0);
            if (yy < H && tl.x0 + 16 * warp + r < W)
              rv[i] = __ldg(reinterpret_cast<const uint4*>(src + (row_pix + r) * pix_bytes +
                                                           16 * u));
          }
        };
        auto put_res = [&](const uint4 (&rv)[4], int at) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<uint4*>(ebuf + ((lane >> 3) + 4 * i) * EPI_ROW + at +
                                      16 * (lane & 7)) = rv[i];
        };
        uint4 rv[4];
        if (!K6 && has_res) {
          load_res(rv, reinterpret_cast<const uint8_t*>(ep.res + tl.co0), (size_t)Co);
          put_res(rv, 128);
        }
        if constexpr (LANE) put_res(mv[j], 0);
        __syncwarp();
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          if (K6 && has_res) {
            load_res(rv, reinterpret_cast<const uint8_t*>(ep.res16 + tl.co0 + 64 * p),
                     (size_t)Co * 2);
            put_res(rv, 128);
            __syncwarp();
          }
#pragma unroll
          for (int n = p * NP; n < (p + 1) * NP; ++n) {
            const int col = 8 * n + 2 * tq;
            const float2 al = *reinterpret_cast<const float2*>(sab + col);
            const float2 be = *reinterpret_cast<const float2*>(sab + BN + col);
            const int sh = 8 * ((phases >> (2 * n)) & 3);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint8_t* row = ebuf + (g + 8 * h) * EPI_ROW;
              float m0 = (float)(int8_t)(mw[j][h] >> sh), m1 = m0;
              if constexpr (LANE) {  // read before the codes overwrite them
                const char2 mk = *reinterpret_cast<const char2*>(row + col);
                m0 = (float)mk.x, m1 = (float)mk.y;
              }
              float v0, v1;
              if constexpr (K6) {
                float2 r = make_float2(0.0f, 0.0f);
                if (has_res)
                  r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                      row + 128 + 2 * (col - 8 * NP * p)));
                v0 = fp_value(acc[j][4 * n + 2 * h], al.x, be.x, has_res, r.x, m0);
                v1 = fp_value(acc[j][4 * n + 2 * h + 1], al.y, be.y, has_res, r.y, m1);
              } else {
                char2 r = make_char2(0, 0);
                if (has_res) r = *reinterpret_cast<const char2*>(row + 128 + col);
                v0 = link_value(acc[j][4 * n + 2 * h], al.x, be.x, has_res, r.x, rs, rsh, m0);
                v1 = link_value(acc[j][4 * n + 2 * h + 1], al.y, be.y, has_res, r.y, rs, rsh,
                                m1);
              }
              if constexpr (S8_OUT) {
                *reinterpret_cast<char2*>(row + col) =
                    make_char2(requant(v0, s_out), requant(v1, s_out));
              } else {
                __nv_bfloat162 v;
                v.x = __float2bfloat16_rn(v0);
                v.y = __float2bfloat16_rn(v1);
                *reinterpret_cast<__nv_bfloat162*>(row + 2 * (col - 8 * NP * p)) = v;
              }
            }
          }
          __syncwarp();
          for (int v = lane; v < 16 * 8; v += 32) {  // 16 pixels x 128 bytes
            const int r = v / 8, u = v % 8;
            if (yy < H && tl.x0 + 16 * warp + r < W)
              *reinterpret_cast<uint4*>(out + ((row_pix + r) * Co + tl.co0) * ES_OUT + 128 * p +
                                        16 * u) =
                  *reinterpret_cast<const uint4*>(ebuf + r * EPI_ROW + 16 * u);
          }
          __syncwarp();
        }
      }
    }
  }
}

// The Co-64 links of K6 (bfloat16, 720^2, 64 -> 64 and 128 -> 64), of K1
// (int8, stage 2 of an INT8_STAGES >= 2 teacher: the same shapes) and of K7
// (K1's under CONV_BLOCK_V1=1, on the interior rows of a pre-padded input),
// the product transposed: D (64 output channels x 128 pixels) = W (64 x K) . X^T,
// so that the pixels are wgmma's N (m64n128, A the weight slice, B a view of
// the halo tile, both K-major as int8 wgmma requires) and the 64 channels its
// M. Untransposed, 64 channels are an n64 product, both of whose operands come
// from shared memory for half the work of an n128 one (P2 reads 365 TFLOP/s
// at N 64, 540-641 at N 128-1024 on an H100), and the mainloop above with a
// 64-channel tile ran K6's links slower than this kernel does. A tile is 2
// output rows x 128 pixels x 64 channels, the tiles taken rows first (with
// columns first, 132 CTAs over 720^2's six tile columns kept each CTA on one
// column, and the CTAs on the edge columns set the time). A chunk is 64 input
// channels: the halo tile is 4 rows x 130 pixels x CB bytes, CB = 128 in the
// 128-byte swizzle (bfloat16) or 64 in the 64-byte swizzle (int8; a chunk of
// 128 int8 channels would be half zeros at C = 64). Tap (ky, kx) of row r is
// the 128 consecutive pixels that start (r + ky) * 130 + kx rows into it. The
// consumers work in ping-pong: each owns whole tiles (two m64n128
// accumulators, one a row) and they take the CTA's tiles in turns, so one's
// epilogue runs beside the other's products (a few percent faster on K6's
// links than both consumers on every tile, a row each, on an H100); the rings
// carry the tiles in order, each slot read by the one consumer whose tile it
// holds, which finds it by the tile's index. A consumer skips the ring phases
// of the other's tiles, which its parity waits cannot tell apart from its
// own, so the mainloops take turns: a consumer starts a tile's products only
// once the other has passed every wait of the tile before (the barriers
// order[], CUTLASS's ping-pong order), and each of its waits is then on the
// phase right after one that has completed.
// Thread (warp w, lane 4 g + tq) holds channels 16 w + g (+ 8) of pixels 8 n
// + 2 tq (+ 1); the epilogue stages a row's 128 pixels in shared memory (the
// residual first, in 16-byte vectors), each thread turns its own elements
// into the output, and the row leaves in 16-byte vectors. K6 turns its
// bfloat16 residual into the output in place. K1 (int8 accumulator, K1's
// epilogue) reads its mask words and its residual into registers while the
// products run, adds its border correction from a table built when the CTA
// starts, computes the link's values in one pass of shared reads
// (link_values) and writes the output in a second pass of shared writes; its
// int8 output replaces its int8 residual in place (80-byte rows), a bfloat16
// output waits until every residual byte of the row has been read. K7 is K1
// with int8 out and a mask byte per output channel (EPI_K7): when a tile
// starts, each consumer copies the tile's 2 x 128 pixels x 64 mask bytes (16
// KB) into its own shared slot with 16-byte cp.async copies, which land
// while the products run, and pads each pixel to 80 bytes, so that the
// epilogue's byte reads (a thread's two channels, 8 apart, at pixels 2 tq
// apart) fall in distinct banks. What bounds K1's and K7's links: the
// epilogue, one warp per SM sub-partition for each consumer, runs longer than
// the other consumer's products (measured on an H100 with builds that leave
// out the products or the epilogue), so a tile pair costs one mainloop and one
// epilogue.
namespace co64 {
constexpr int TH = 2, TW = 128, HALO_H = TH + 2, HALO_W = TW + 2;
constexpr int MASK_WORDS = 2 * 2 * 2 * TW;  // consumer x tile parity x row x pixel
// K7's mask, a byte per output channel: per consumer the tile's 2 rows x 128
// pixels of 64 bytes, each pixel padded to LANE_ROW bytes so that a warp's
// reads are conflict-free
constexpr int LANE_ROW = 80, LANE_BYTES = 2 * TW * LANE_ROW;
// K1's border table: per class of pixel (row 0, row H - 1, column 0, column W
// - 1: four flags) and output channel, zpad x the weight sums of the taps that
// read outside the image
constexpr int BORDER_INTS = 16 * 64;
// a chunk is 64 input channels, CB = 128 bytes a pixel in bfloat16 (K6) or 64
// in int8 (K1); one halo tile (66 560 or 33 280 bytes) and one weight slice
__host__ __device__ constexpr int a_bytes(int cb) { return HALO_H * HALO_W * cb; }
__host__ __device__ constexpr int a_stage(int cb) { return (a_bytes(cb) + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int w_bytes(int cb) { return 64 * cb; }
constexpr int A_STAGES = 2, W_STAGES = 6;
// a staged pixel: 64 output bytes and a pad (K1's and K7's int8 links), else
// 128 and a pad; the pad keeps every thread's element access conflict-free
__host__ __device__ constexpr int out_row(int epi) {
  return epi == EPI_K1_S8 || epi == EPI_K7 ? 80 : 144;
}
// the mask words (K1, K6) or K7's mask bytes, both consumers'
__host__ __device__ constexpr int mask_bytes(int epi) {
  return epi == EPI_K7 ? 2 * LANE_BYTES : MASK_WORDS * 4;
}
constexpr int smem(int cb, int epi) {
  return 1024 + A_STAGES * a_stage(cb) + W_STAGES * w_bytes(cb) + 2 * TW * out_row(epi) +
         mask_bytes(epi) + (epi == EPI_K6 ? 0 : BORDER_INTS * 4) +
         2 * 8 * (A_STAGES + W_STAGES + 1);
}
static_assert(smem(128, EPI_K6) <= 232448 && smem(64, EPI_K1_BF16) <= 232448 &&
                  smem(64, EPI_K7) <= 232448,
              "co64 layout");

// the descriptor of a K-major view in the chunk's swizzle
template <int CB>
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  if constexpr (CB == 128)
    return rdt::wgmma_desc_sw128_rows(addr, 1024);
  else
    return rdt::wgmma_desc_sw64_rows(addr, 512);
}
}  // namespace co64

// The first pass of K1's epilogue in the Co-64 kernel below, over one
// accumulator row: link_value in place, the float values left as bits in the
// accumulators; the residual bytes staged in `row0`'s pixels, OUT_ROW bytes
// apart. K1's mask bytes lie in the words `mrow`: both rows' channels, 8
// apart, lie in one mask phase (16, 32 or 64 channels), the byte at bit `sh`.
// K7's (LANE) lie in `lrow`, a byte per channel, pixels co64::LANE_ROW bytes
// apart. Reads of shared memory only, and the residual's branch out of the
// loop, so that the elements' chains overlap.
template <bool RES, bool LANE, int OUT_ROW>
__device__ __forceinline__ void link_values(int (&a)[64], const int8_t* row0,
                                            const uint32_t* mrow, const int8_t* lrow, int tq,
                                            const int (&co_r)[2], const float (&al)[2],
                                            const float (&be)[2], int sh, float rs, float rsh) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int px = 8 * n + 2 * tq + e;
      float m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if constexpr (LANE)
          m[r] = (float)lrow[px * co64::LANE_ROW + co_r[r]];
        else
          m[r] = (float)(int8_t)(mrow[px] >> sh);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int& v = a[4 * n + 2 * r + e];
        v = __float_as_int(link_value(v, al[r], be[r], RES, RES ? row0[px * OUT_ROW + co_r[r]] : 0,
                                      rs, rsh, m[r]));
      }
    }
}

template <class T, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
conv_co64_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                 uint8_t* __restrict__ out, const EpiArgs ep, int B, int H, int W, int C,
                 int kh) {
  // LANE: K7's mask, a byte per output channel
  constexpr bool K6 = EPI == EPI_K6, LANE = EPI == EPI_K7, S8_OUT = EPI == EPI_K1_S8 || LANE;
  static_assert(K6 == std::is_same<T, Bf16>::value, "K6 in bfloat16, K1 and K7 in int8");
  using acc_t = typename T::acc_t;
  constexpr int CH = 64, CB = CH * T::ES, CO = 64, TW = co64::TW, TH = co64::TH;
  constexpr int HALO_W = co64::HALO_W;
  constexpr int A_STAGES = co64::A_STAGES, W_STAGES = co64::W_STAGES;
  constexpr int A_BYTES = co64::a_bytes(CB), A_STAGE = co64::a_stage(CB);
  constexpr int W_BYTES = co64::w_bytes(CB), OUT_ROW = co64::out_row(EPI);
  // bytes a pixel of the residual and of the output
  constexpr int RES_PIX = K6 ? 2 * CO : CO, OUT_PIX = S8_OUT ? CO : 2 * CO;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned by an offset into the shared array, so that the
  // compiler keeps the address space (shared loads and stores in the
  // epilogue, not generic ones)
  uint8_t* sa = smem_raw + ((1024u - rdt::smem_addr(smem_raw)) & 1023u);
  uint8_t* sw = sa + A_STAGES * A_STAGE;
  uint8_t* so_all = sw + W_STAGES * W_BYTES;
  uint8_t* smask_raw = so_all + 2 * TW * OUT_ROW;
  uint32_t* smask_all = reinterpret_cast<uint32_t*>(smask_raw);
  int* sborder = reinterpret_cast<int*>(smask_raw + co64::mask_bytes(EPI));
  uint64_t* full_a = reinterpret_cast<uint64_t*>(sborder + (K6 ? 0 : co64::BORDER_INTS));
  uint64_t* empty_a = full_a + A_STAGES;
  uint64_t* full_b = empty_a + A_STAGES;
  uint64_t* empty_b = full_b + W_STAGES;
  uint64_t* order = empty_b + W_STAGES;  // order[cw]: the other consumer's mainloops done

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      rdt::mbar_init(full_a + s, 1);
      rdt::mbar_init(empty_a + s, 1);
    }
    for (int s = 0; s < W_STAGES; ++s) {
      rdt::mbar_init(full_b + s, 1);
      rdt::mbar_init(empty_b + s, 1);
    }
    for (int s = 0; s < 2; ++s) rdt::mbar_init(order + s, 128);
    rdt::mbar_init_fence();
  }
  if constexpr (!K6) {
    // the border table: entry (class f, channel co), f's bits row 0, row H -
    // 1, column 0, column W - 1 (tap (ky, kx) reads row y + ky - 1, column x +
    // kx - 1)
    for (int i = threadIdx.x; i < co64::BORDER_INTS; i += THREADS) {
      const int f = i / CO, co = i % CO;
      int sum = 0;
      for (int ky = 0; ky < kh; ++ky)
        for (int kx = 0; kx < kh; ++kx)
          if (((f & 1) && ky == 0) || ((f & 2) && ky == 2) || ((f & 4) && kx == 0) ||
              ((f & 8) && kx == 2))
            sum += __ldg(ep.wsum + (ky * kh + kx) * CO + co);
      sborder[i] = ep.zpad * sum;
    }
  }
  __syncthreads();

  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int n_tiles = B * tiles_y * tiles_x;
  const int chunks = C / CH, taps = kh * kh;

  if (wg == 0) {  // ------------------------------------------------ producer
    rdt::setmaxnreg_dec<40>();
    if (tid != 0) return;
    rdt::tma_prefetch_desc(&tmx);
    rdt::tma_prefetch_desc(&tmw);
    int ia = 0, pa = 0, ib = 0, pb = 0;
    for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
      const int b = id / (tiles_x * tiles_y), y0 = (id % tiles_y) * TH,
                x0 = ((id / tiles_y) % tiles_x) * TW;
      for (int c = 0; c < chunks; ++c) {
        rdt::mbar_wait(empty_a + ia, pa ^ 1);
        rdt::mbar_arrive_expect_tx(full_a + ia, A_BYTES);
        rdt::tma_load_4d(sa + ia * A_STAGE, &tmx, full_a + ia, c * CH, x0 - 1, y0 - 1, b);
        if (++ia == A_STAGES) ia = 0, pa ^= 1;
        for (int t = 0; t < taps; ++t) {
          rdt::mbar_wait(empty_b + ib, pb ^ 1);
          rdt::mbar_arrive_expect_tx(full_b + ib, W_BYTES);
          rdt::tma_load_3d(sw + ib * W_BYTES, &tmw, full_b + ib, c * CH, 0, t);
          if (++ib == W_STAGES) ib = 0, pb ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  rdt::setmaxnreg_inc<232>();
  const int cw = wg - 1;  // takes the CTA's tiles cw, cw + 2, ...
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  uint8_t* so = so_all + cw * TW * OUT_ROW;
  uint32_t* smask = smask_all + cw * 2 * 2 * TW;
  int8_t* slane = reinterpret_cast<int8_t*>(smask_raw) + cw * co64::LANE_BYTES;  // K7's
  const uint32_t sa_addr = rdt::smem_addr(sa), sw_addr = rdt::smem_addr(sw);
  const int co_r[2] = {16 * warp + g, 16 * warp + g + 8};
  float al[2], be[2];
  int sh[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    al[r] = __ldg(ep.ab + co_r[r]);
    be[r] = __ldg(ep.ab + CO + co_r[r]);
    sh[r] = LANE ? 0 : 8 * (co_r[r] / (CO / ep.nph));
  }
  float s_out = 0.0f, rs = 0.0f, rsh = 0.0f;
  if constexpr (!K6) {
    s_out = __ldg(ep.ab + 2 * CO), rs = __ldg(ep.ab + 3 * CO), rsh = __ldg(ep.ab + 4 * CO);
  }
  const uint8_t* res = K6 ? reinterpret_cast<const uint8_t*>(ep.res16)
                          : reinterpret_cast<const uint8_t*>(ep.res);
  const bool has_res = res != nullptr;
  acc_t acc[2][64];
  int parity = 0;
  for (int i = cw, id = blockIdx.x + cw * gridDim.x; id < n_tiles;
       i += 2, id += 2 * gridDim.x, parity ^= 1) {
    const int b = id / (tiles_x * tiles_y), y0 = (id % tiles_y) * TH,
              x0 = ((id / tiles_y) % tiles_x) * TW;
    // the two rows' mask words, read into registers now and stored in this
    // tile's shared slot after the products, so that the reads land while
    // the products run; their residual into L2
    uint32_t mw_own[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int yy = y0 + j;
      if (yy < H && x0 + tid < W) {
        const size_t pix = ((size_t)b * H + yy) * W + x0 + tid;
        if constexpr (!LANE) {
          const int8_t* mp = ep.mask + pix * ep.nph;
          mw_own[j] = ep.nph == 4   ? __ldg(reinterpret_cast<const uint32_t*>(mp))
                      : ep.nph == 2 ? (uint32_t)__ldg(reinterpret_cast<const uint16_t*>(mp))
                                    : (uint32_t)(uint8_t)__ldg(mp);
        }
        if (has_res) prefetch_l2(res + pix * RES_PIX);
      }
    }
    // K7: the two rows' mask bytes (16 KB) straight into this consumer's
    // shared slots, 16-byte copies that land while the products run; every
    // thread of the consumer read the last tile's bytes before its last
    // barrier of that tile, so one slot per consumer does
    if constexpr (LANE) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int v = tid + 128 * q, j = v >> 9, px = (v >> 2) & (TW - 1), u = v & 3;
        if (y0 + j < H && x0 + px < W)
          cp_async_16(rdt::smem_addr(slane + (j * TW + px) * co64::LANE_ROW + 16 * u),
                      ep.mask + (((size_t)b * H + y0 + j) * W + x0 + px) * CO + 16 * u);
      }
      cp_async_commit();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 64; ++k) acc[j][k] = 0;
    int prev_a = -1, prev_b = -1;  // slots whose last products may still run
    // the other consumer has waited on every phase of the tile before: phase
    // k of order[1] ends consumer 0's tile 2k, phase k of order[0] consumer
    // 1's tile 2k + 1
    if (cw == 1)
      rdt::mbar_wait(order + 1, parity);
    else if (i > 0)
      rdt::mbar_wait(order, parity ^ 1);

#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
      const int sa_seq = i * chunks + c, ia = sa_seq % A_STAGES;
      rdt::mbar_wait(full_a + ia, (sa_seq / A_STAGES) & 1);
      const uint32_t a_base = sa_addr + ia * A_STAGE;
#pragma unroll 1
      for (int t = 0; t < taps; ++t) {
        const int sb_seq = sa_seq * taps + t, ib = sb_seq % W_STAGES;
        rdt::mbar_wait(full_b + ib, (sb_seq / W_STAGES) & 1);
        const int ky = t / kh, kx = t - ky * kh;
        const uint32_t px_tap = a_base + (ky * HALO_W + kx) * CB;
        const uint32_t w_tap = sw_addr + ib * W_BYTES;
        rdt::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < CB; ks += 32) {  // one instruction: 32 bytes of K
          const uint64_t dw = co64::desc<CB>(w_tap + ks);
          T::mma(acc[0], dw, co64::desc<CB>(px_tap + ks));
          T::mma(acc[1], dw, co64::desc<CB>(px_tap + HALO_W * CB + ks));
        }
        rdt::wgmma_commit();
        rdt::wgmma_wait<1>();  // the previous tap's products are done
        if (prev_b >= 0 && tid == 0) rdt::mbar_arrive(empty_b + prev_b);
        prev_b = ib;
        if (t == 0 && prev_a >= 0) {  // ... and with them the previous chunk's
          if (tid == 0) rdt::mbar_arrive(empty_a + prev_a);
          prev_a = -1;
        }
      }
      prev_a = ia;
    }
    rdt::mbar_arrive(order + (cw ^ 1));  // every thread, its last wait passed
    // K1: both rows' residual (64 bytes a pixel) into registers, 16-byte
    // vectors, read while the last products run
    constexpr int RES_VECS = RES_PIX / 16;
    uint4 rv_k1[2][K6 ? 1 : RES_VECS];
    if constexpr (!K6) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < RES_VECS; ++q) {
          const int v = tid + 128 * q, px = v / RES_VECS, u = v % RES_VECS;
          rv_k1[j][q] = make_uint4(0, 0, 0, 0);
          if (has_res && y0 + j < H && x0 + px < W)
            rv_k1[j][q] = __ldg(reinterpret_cast<const uint4*>(
                                    res + (((size_t)b * H + y0 + j) * W + x0 + px) * RES_PIX) +
                                u);
        }
    }
    rdt::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 64; ++k) fence_operand(acc[j][k]);
    if (tid == 0) {
      rdt::mbar_arrive(empty_b + prev_b);
      rdt::mbar_arrive(empty_a + prev_a);
    }
    if constexpr (LANE) {
      cp_async_wait_all();  // the barrier at the first row shows them to the consumer
    } else {
#pragma unroll
      for (int j = 0; j < 2; ++j) smask[(parity * 2 + j) * TW + tid] = mw_own[j];
    }

    // epilogue, a row at a time through the staging rows: the row's
    // accumulators are acc[0] (row 1's move there after row 0), so that the
    // code of a row is emitted once (unrolled over both rows, the epilogue
    // ran slower: measured on an H100)
#pragma unroll 1
    for (int j = 0; j < 2; ++j) {
      const int yy = y0 + j;
      const bool row_in = yy < H;
      const size_t row_pix = ((size_t)b * H + yy) * W + x0;
      consumer_sync(cw);  // the staging rows are free, the mask words in place
      if (has_res) {
#pragma unroll
        for (int q = 0; q < RES_VECS; ++q) {
          const int v = tid + 128 * q, px = v / RES_VECS, u = v % RES_VECS;
          uint4 rv;
          if constexpr (K6) {
            rv = make_uint4(0, 0, 0, 0);
            if (row_in && x0 + px < W)
              rv = __ldg(reinterpret_cast<const uint4*>(res + (row_pix + px) * RES_PIX) + u);
          } else {
            rv = rv_k1[0][q];
          }
          *reinterpret_cast<uint4*>(so + px * OUT_ROW + 16 * u) = rv;
        }
        consumer_sync(cw);
      }
      const uint32_t* mrow = smask + (parity * 2 + j) * TW;
      if constexpr (K6) {
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int px = 8 * n + 2 * tq + e;
            const uint32_t mw = mrow[px];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(so + px * OUT_ROW) + co_r[r];
              const float m = (float)(int8_t)(mw >> sh[r]);
              const float rv = has_res ? __bfloat162float(*el) : 0.0f;
              *el = __float2bfloat16_rn(
                  fp_value(acc[0][4 * n + 2 * r + e], al[r], be[r], has_res, rv, m));
            }
          }
      } else {
        // K1's border correction, in the exact int32 accumulator, from the
        // border table: every pixel of rows 0 and H - 1 takes its row's
        // class, pixels 0 and W - 1 of a row their own
        if (ep.zpad != 0 && row_in && (yy == 0 || yy == H - 1 || x0 == 0 || x0 + TW >= W)) {
          const int* row_class = sborder + ((yy == 0) | (yy == H - 1) << 1) * CO;
          if (yy == 0 || yy == H - 1)
#pragma unroll
            for (int k = 0; k < 64; ++k) acc[0][k] += row_class[co_r[(k >> 1) & 1]];
          // the columns' share: class f (flags 4: column 0, 8: column W - 1)
          // less the row's class
          auto column = [&](int px, int f) {
#pragma unroll
            for (int n = 0; n < 16; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (8 * n + 2 * tq + e == px)
#pragma unroll
                  for (int r = 0; r < 2; ++r)
                    acc[0][4 * n + 2 * r + e] += row_class[f * CO + co_r[r]] - row_class[co_r[r]];
          };
          if (x0 == 0) column(0, W == 1 ? 12 : 4);
          if (x0 + TW >= W && W > 1) column(W - 1 - x0, 8);
        }
        // two passes: the link's values into the accumulators (reads of the
        // shared mask words and residual bytes only), then the output into
        // the staging rows (writes only), so that no read waits on a write
        // before it
        const int8_t* row0 = reinterpret_cast<const int8_t*>(so);
        const int8_t* lrow = slane + j * TW * co64::LANE_ROW;
        if (has_res)
          link_values<true, LANE, OUT_ROW>(acc[0], row0, mrow, lrow, tq, co_r, al, be, sh[0], rs,
                                           rsh);
        else
          link_values<false, LANE, OUT_ROW>(acc[0], row0, mrow, lrow, tq, co_r, al, be, sh[0], rs,
                                            rsh);
        // an int8 code takes its own residual byte's place; a bfloat16 value
        // also covers other threads' residual bytes
        if (!S8_OUT && has_res) consumer_sync(cw);
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              uint8_t* row = so + (8 * n + 2 * tq + e) * OUT_ROW;
              const float v = __int_as_float(acc[0][4 * n + 2 * r + e]);
              if constexpr (S8_OUT)
                reinterpret_cast<signed char*>(row)[co_r[r]] = requant(v, s_out);
              else
                reinterpret_cast<__nv_bfloat16*>(row)[co_r[r]] = __float2bfloat16_rn(v);
            }
      }
      consumer_sync(cw);
      constexpr int VECS = OUT_PIX / 16;
#pragma unroll
      for (int q = 0; q < VECS; ++q) {  // the row out, 16-byte vectors
        const int v = tid + 128 * q, px = v / VECS, u = v % VECS;
        if (row_in && x0 + px < W)
          reinterpret_cast<uint4*>(out + (row_pix + px) * OUT_PIX)[u] =
              *reinterpret_cast<const uint4*>(so + px * OUT_ROW + 16 * u);
      }
      if (j == 0) {
#pragma unroll
        for (int k = 0; k < 64; ++k) acc[0][k] = acc[1][k];
#pragma unroll
        for (int q = 0; q < (K6 ? 1 : RES_VECS); ++q) rv_k1[0][q] = rv_k1[1][q];
      }
    }
  }
}

// x (B, H, W, C) and wk (kh * kh, 64, C) in T's type, C a multiple of 64;
// x's images x_rows rows apart (H but for K7's view of the interior rows of
// its padded input)
template <class T, int EPI>
cudaError_t launch_co64(const void* x, const void* wk, const EpiArgs& ep, void* out, int B, int H,
                        int x_rows, int W, int C, int kh, int device, cudaStream_t stream) {
  constexpr int CH = 64, CB = CH * T::ES;
  constexpr CUtensorMapSwizzle SWIZZLE =
      CB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t es = T::ES;
  CUtensorMap tmx, tmw;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {C * es, (cuuint64_t)W * C * es,
                                  (cuuint64_t)x_rows * W * C * es};
  const cuuint32_t xbox[4] = {CH, co64::HALO_W, co64::HALO_H, 1};
  cudaError_t err = rdt::encode_swizzled(&tmx, T::TMA_TYPE, 4, x, xdims, xstrides, xbox, SWIZZLE);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)C, 64, (cuuint64_t)(kh * kh)};
  const cuuint64_t wstrides[2] = {C * es, 64ull * C * es};
  const cuuint32_t wbox[3] = {CH, 64, 1};
  err = rdt::encode_swizzled(&tmw, T::TMA_TYPE, 3, wk, wdims, wstrides, wbox, SWIZZLE);
  if (err != cudaSuccess) return err;
  auto kernel = conv_co64_kernel<T, EPI>;
  constexpr int smem = co64::smem(CB, EPI);
  static int configured = -1;  // the device whose attribute was set
  if (configured != device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles =
      (long long)B * ((H + co64::TH - 1) / co64::TH) * ((W + co64::TW - 1) / co64::TW);
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, THREADS, smem, stream>>>(tmx, tmw, static_cast<uint8_t*>(out), ep, B, H, W, C,
                                          kh);
  return cudaGetLastError();
}

// x: Hin rows of each image, images x_rows rows apart (Hin but for K7's
// view of the interior rows of its padded input)
template <class T, int EPI>
cudaError_t launch(const void* x, const void* wk, const EpiArgs& ep, void* out, int B, int Hin,
                   int x_rows, int H, int W, int C, int Co, int kh, int row_off, int shift,
                   int flip, int device, cudaStream_t stream) {
  constexpr int CH = ROW / T::ES;
  CUtensorMap tmx, tmw;
  const cuuint64_t es = T::ES;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)Hin, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {C * es, (cuuint64_t)W * C * es,
                                  (cuuint64_t)x_rows * W * C * es};
  const cuuint32_t xbox[4] = {CH, HALO_W, HALO_H, 1};
  cudaError_t err = rdt::encode_sw128(&tmx, T::TMA_TYPE, 4, x, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)C, (cuuint64_t)Co, (cuuint64_t)(kh * kh)};
  const cuuint64_t wstrides[2] = {C * es, (cuuint64_t)Co * C * es};
  const cuuint32_t wbox[3] = {CH, BN, 1};
  err = rdt::encode_sw128(&tmw, T::TMA_TYPE, 3, wk, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;

  static int configured = -1;  // the device whose attribute was set
  if (configured != device) {
    err = cudaFuncSetAttribute(conv_wgmma_kernel<T, EPI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long n_tiles =
      (long long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (Co / BN);
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  conv_wgmma_kernel<T, EPI><<<grid, THREADS, SMEM, stream>>>(
      tmx, tmw, static_cast<uint8_t*>(out), ep, B, H, W, C, Co, kh, row_off, shift, flip);
  return cudaGetLastError();
}

}  // namespace

// x (B, Hin, W, C) and wk (9, Co, C) contiguous, 16-byte aligned; out (B, H,
// W, Co). Output row y reads input rows y + row_off .. y + row_off + 2 (K9:
// Hin = H, row_off = -1; P1: Hin = H + 2, row_off = 0). mode 0 = conv, 1 =
// dots (bfloat16 in and out, scale unused), 2 = int8 (the dots products in
// int8, then P1's requant with scale (Co,) float32 and relu). flip reads the
// taps in reverse order. C a multiple of 64 (bfloat16) or 128 (int8)
// channels, Co a multiple of 128.
extern "C" int rdt_conv3x3_wgmma(const void* x, const void* wk, const void* scale, void* out,
                                 int B, int Hin, int H, int W, int C, int Co, int row_off,
                                 int mode, int flip, int relu, int device, void* stream) {
  if (mode < 0 || mode > 2 || C <= 0 || C % (mode == 2 ? 128 : 64) != 0 || Co <= 0 ||
      Co % 128 != 0 || (mode == 2 && scale == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  EpiArgs ep = {};
  ep.scale = static_cast<const float*>(scale);
  ep.relu = relu;
  if (mode == 2)
    return launch<S8, EPI_P1>(x, wk, ep, out, B, Hin, Hin, H, W, C, Co, 3, row_off, 0, flip,
                              device, st);
  return launch<Bf16, EPI_BF16>(x, wk, ep, out, B, Hin, Hin, H, W, C, Co, 3, row_off, mode == 0,
                                flip, device, st);
}

// K1 on the mainloop. x (B, H, W, C) int8; wk (kh * kh, Co, C) int8, the taps
// K-major; ab (8, Co) float32, rows alpha, beta, s_out, rs, rsh; mask (B, H,
// W, nph) int8, nph 1, 2 or 4, channel co reading phase co / (Co / nph); res
// (B, H, W, Co) int8 or null; wsum (kh * kh, Co) int32, wk summed over C; out
// (B, H, W, Co) int8 (out_kind 0) or bfloat16 (2). kh 3 (padding (1, 1)) or
// 2 (padding (1, 0)); padding cells hold zpad. Every tensor contiguous and
// 16-byte aligned; C and Co multiples of 128, or Co 64 (the transposed
// kernel) and C a multiple of 64.
extern "C" int rdt_conv_block_wgmma(const void* x, const void* wk, const void* ab,
                                    const void* mask, const void* res, const void* wsum,
                                    void* out, int B, int H, int W, int C, int Co, int kh,
                                    int nph, int zpad, int out_kind, int device, void* stream) {
  const bool narrow = Co == 64 && C > 0 && C % 64 == 0;  // the transposed kernel
  if (!(narrow || (C > 0 && C % 128 == 0 && Co > 0 && Co % 128 == 0)) || (kh != 2 && kh != 3) ||
      (nph != 1 && nph != 2 && nph != 4) || (out_kind != 0 && out_kind != 2) ||
      ab == nullptr || mask == nullptr || wsum == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  EpiArgs ep = {};
  ep.ab = static_cast<const float*>(ab);
  ep.mask = static_cast<const int8_t*>(mask);
  ep.res = static_cast<const int8_t*>(res);
  ep.wsum = static_cast<const int*>(wsum);
  ep.nph = nph;
  ep.zpad = zpad;
  if (narrow)
    return out_kind == 0
               ? launch_co64<S8, EPI_K1_S8>(x, wk, ep, out, B, H, H, W, C, kh, device, st)
               : launch_co64<S8, EPI_K1_BF16>(x, wk, ep, out, B, H, H, W, C, kh, device, st);
  if (out_kind == 0)
    return launch<S8, EPI_K1_S8>(x, wk, ep, out, B, H, H, H, W, C, Co, kh, -1, 1, 0, device, st);
  return launch<S8, EPI_K1_BF16>(x, wk, ep, out, B, H, H, H, W, C, Co, kh, -1, 1, 0, device, st);
}

// K7 on the mainloop: K1's int8 link on the first generation's operands. x
// points at the first interior row of image 0 of the padded input (B, H + kh
// - 1, W, C) int8, the images x_rows = H + kh - 1 rows apart: the mainloop
// reads rows 0 .. H - 1 of each and never the zpad rows around them. mask
// (B, H, W, Co) int8, one byte per output channel; the other operands and
// the result as for rdt_conv_block_wgmma, int8 out. Every tensor 16-byte
// aligned and contiguous but for x's image stride; C and Co multiples of 128,
// or Co 64 (the transposed kernel) and C a multiple of 64.
extern "C" int rdt_chain_conv_wgmma(const void* x, const void* wk, const void* ab,
                                    const void* mask, const void* res, const void* wsum,
                                    void* out, int B, int H, int W, int C, int Co, int kh,
                                    int x_rows, int zpad, int device, void* stream) {
  const bool narrow = Co == 64 && C > 0 && C % 64 == 0;  // the transposed kernel
  if (!(narrow || (C > 0 && C % 128 == 0 && Co > 0 && Co % 128 == 0)) || (kh != 2 && kh != 3) ||
      x_rows < H || ab == nullptr || mask == nullptr || wsum == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  EpiArgs ep = {};
  ep.ab = static_cast<const float*>(ab);
  ep.mask = static_cast<const int8_t*>(mask);
  ep.res = static_cast<const int8_t*>(res);
  ep.wsum = static_cast<const int*>(wsum);
  ep.nph = Co;
  ep.zpad = zpad;
  auto st = static_cast<cudaStream_t>(stream);
  if (narrow) return launch_co64<S8, EPI_K7>(x, wk, ep, out, B, H, x_rows, W, C, kh, device, st);
  return launch<S8, EPI_K7>(x, wk, ep, out, B, H, x_rows, H, W, C, Co, kh, -1, 1, 0, device, st);
}

// K6 on the mainloop. x (B, H, W, C) bfloat16; wk (kh * kh, Co, C) bfloat16,
// the taps K-major; ab (2, Co) float32, rows alpha, beta; mask (B, H, W, nph)
// int8, nph 1, 2 or 4 with Co / nph a multiple of 8, channel co reading phase
// co / (Co / nph); res (B, H, W, Co) bfloat16 or null; out (B, H, W, Co)
// bfloat16. kh 3 (padding (1, 1)) or 2 (padding (1, 0)), padding cells zero.
// Every tensor contiguous and 16-byte aligned; C a multiple of 64, Co a
// multiple of 128 (tiles of 128 channels) or 64 (one tile of 64).
extern "C" int rdt_conv_block_fp_wgmma(const void* x, const void* wk, const void* ab,
                                       const void* mask, const void* res, void* out, int B,
                                       int H, int W, int C, int Co, int kh, int nph, int device,
                                       void* stream) {
  if (C <= 0 || C % 64 != 0 || !(Co == 64 || (Co > 0 && Co % 128 == 0)) ||
      (kh != 2 && kh != 3) || (nph != 1 && nph != 2 && nph != 4) || (Co / nph) % 8 != 0 ||
      ab == nullptr || mask == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  EpiArgs ep = {};
  ep.ab = static_cast<const float*>(ab);
  ep.mask = static_cast<const int8_t*>(mask);
  ep.res16 = static_cast<const __nv_bfloat16*>(res);
  ep.nph = nph;
  if (Co == 64)
    return launch_co64<Bf16, EPI_K6>(x, wk, ep, out, B, H, H, W, C, kh, device, st);
  return launch<Bf16, EPI_K6>(x, wk, ep, out, B, H, H, H, W, C, Co, kh, -1, 1, 0, device, st);
}
