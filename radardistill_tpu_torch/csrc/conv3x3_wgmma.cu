// The Hopper 3x3 conv mainloop: TMA loads into mbarrier rings, wgmma from
// shared memory, a persistent grid. Two kernels of the port run on it:
//
//   K9  ops/wide_conv.py::conv3x3_wide, bfloat16 y and dx (replaces
//       radardistill_tpu/ops/pallas_wide_conv.py::_wide_kernel): the 3x3
//       stride-1 pad-1 conv of x (B, H, W, C), float32 accumulation,
//       bfloat16 out;
//   P1  ops/probes.py::conv_probe(route="wgmma") (replaces the kernels of
//       tools/pallas_conv_proto.py): conv, dots and int8 on an input that is
//       pre-padded by one zero row above and below, xp (B, H + 2, W, C).
//
// The weight arrives K-major, wk (9, Co, C): tap t's (Co, C) slice. For dx
// the caller passes the forward's (3, 3, Co_f, C_f) kernel as it lies, which
// is (9, N, K) of the dx conv with the taps reversed (`flip`).
//
// What bounds it: operations (2 * 9 * C * Co per pixel against 2 * (C + Co)
// bytes), so the design feeds the tensor cores and hides every copy:
//
// - A CTA of three warpgroups owns 4 x 64 output pixels by 128 output
//   channels. Warpgroup 0 is the producer: one thread issues the TMA loads
//   and the warpgroup gives its registers away (setmaxnreg). Warpgroups 1 and
//   2 consume: each holds two m64 x n128 float32 (or int32) accumulators, two
//   output rows of 64 pixels.
// - Per chunk of 128 bytes of input channels (64 bfloat16, 128 int8) one TMA
//   box brings the tile with its halo, 6 rows x 66 pixels, in the 128-byte
//   swizzle; the zero fill of out-of-bounds boxes is the conv's padding (K9's
//   rows -1 and H, every input's columns -1 and W; P1's rows come pre-padded).
//   A tap's A operand is a VIEW of that tile: output row r, tap (ky, kx)
//   starts (r + ky) * 66 + kx rows into it, 8-row groups 1024 bytes apart;
//   the descriptor's base-offset field stays 0 (the tensor core swizzles by
//   the address bits it reads, as TMA stored them; measured on an H100,
//   see wgmma_ops.cuh). One staged halo serves all nine taps.
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
// - Epilogue: float32 -> bfloat16 round-to-nearest-even (K9, conv, dots), or
//   P1's int8 requant, exactly the mma.sync route's (__fmul_rn, rintf);
//   each warp stages its 16 pixels x 128 channels in shared memory and stores
//   them as 16-byte vectors.

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
constexpr int THREADS = 384;
constexpr int SMEM = 1024 + A_STAGES * A_STAGE + B_STAGES * B_BYTES + 8 * EPI_WARP +
                     2 * 8 * (A_STAGES + B_STAGES);

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
// HALO_H, 1); tmw: the weight (9, Co, C) as a 3-d map, box (ROW / ES, BN, 1).
// row_off: the input row of output row 0's tap ky = 0 (-1 unpadded, 0 for a
// pre-padded input). shift: conv (1) or dots (0, every tap reads the centre).
template <class T>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                     uint8_t* __restrict__ out, const float* __restrict__ scale, int B, int H,
                     int W, int C, int Co, int row_off, int shift, int flip, int relu) {
  using acc_t = typename T::acc_t;
  constexpr int CH = ROW / T::ES;  // channels per chunk
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                           ~(uintptr_t)1023);
  uint8_t* sb = sa + A_STAGES * A_STAGE;
  uint8_t* se = sb + B_STAGES * B_BYTES;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(se + 8 * EPI_WARP);
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
  const int chunks = C / CH;

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
        for (int t = 0; t < 9; ++t) {
          rdt::mbar_wait(empty_b + ib, pb ^ 1);
          rdt::mbar_arrive_expect_tx(full_b + ib, B_BYTES);
          rdt::tma_load_3d(sb + ib * B_BYTES, &tmw, full_b + ib, c * CH, tl.co0, flip ? 8 - t : t);
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

  for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
    const Tile tl = tile_of(id, H, W, Co);
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
      for (int t = 0; t < 9; ++t) {
        rdt::mbar_wait(full_b + ib, pb);
        const int ky = shift ? t / 3 : 0, kx = shift ? t % 3 : 1;
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
    constexpr int ROW_OUT = BN * T::ES, VECS = ROW_OUT / 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint8_t* dst = ebuf + (g + 8 * h) * EPI_ROW;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          const int col = 8 * n + 2 * tq;
          if constexpr (std::is_same<T, Bf16>::value) {
            __nv_bfloat162 v;
            v.x = __float2bfloat16_rn(acc[j][4 * n + 2 * h]);
            v.y = __float2bfloat16_rn(acc[j][4 * n + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dst + 2 * col) = v;
          } else {
            *reinterpret_cast<char2*>(dst + col) =
                make_char2(quantize(acc[j][4 * n + 2 * h], __ldg(scale + tl.co0 + col), relu),
                           quantize(acc[j][4 * n + 2 * h + 1], __ldg(scale + tl.co0 + col + 1),
                                    relu));
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
  }
}

template <class T>
cudaError_t launch(const void* x, const void* wk, const float* scale, void* out, int B, int Hin,
                   int H, int W, int C, int Co, int row_off, int shift, int flip, int relu,
                   int device, cudaStream_t stream) {
  constexpr int CH = ROW / T::ES;
  CUtensorMap tmx, tmw;
  const cuuint64_t es = T::ES;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)Hin, (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {C * es, (cuuint64_t)W * C * es, (cuuint64_t)Hin * W * C * es};
  const cuuint32_t xbox[4] = {CH, HALO_W, HALO_H, 1};
  cudaError_t err = rdt::encode_sw128(&tmx, T::TMA_TYPE, 4, x, xdims, xstrides, xbox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[3] = {(cuuint64_t)C, (cuuint64_t)Co, 9};
  const cuuint64_t wstrides[2] = {C * es, (cuuint64_t)Co * C * es};
  const cuuint32_t wbox[3] = {CH, BN, 1};
  err = rdt::encode_sw128(&tmw, T::TMA_TYPE, 3, wk, wdims, wstrides, wbox);
  if (err != cudaSuccess) return err;

  static int configured = -1;  // the device whose attribute was set
  if (configured != device) {
    err = cudaFuncSetAttribute(conv3x3_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
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
  conv3x3_wgmma_kernel<T><<<grid, THREADS, SMEM, stream>>>(
      tmx, tmw, static_cast<uint8_t*>(out), scale, B, H, W, C, Co, row_off, shift, flip, relu);
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
      Co % BN != 0 || (mode == 2 && scale == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  if (mode == 2)
    return launch<S8>(x, wk, static_cast<const float*>(scale), out, B, Hin, H, W, C, Co, row_off,
                      0, flip, relu, device, st);
  return launch<Bf16>(x, wk, nullptr, out, B, Hin, H, W, C, Co, row_off, mode == 0, flip, 0,
                      device, st);
}
