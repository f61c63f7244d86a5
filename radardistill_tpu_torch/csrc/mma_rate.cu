// P2: tensor-core rate probe with operands resident on chip.
//
//   out = sum over r < reps of  round_to_type(A + r) @ B
//
// A (M, K) and B (K, N) of one type: bfloat16 (float32 accumulation, bfloat16
// out), int8 (int32 accumulation, int32 out; A + r wraps as int8 addition
// does) or float32 run as TF32 products (float32 accumulation and out). B
// arrives transposed, (N, K) with K contiguous.
//
// Replaces the TPU probe tools/mxu_rate.py (main.case, kern): eight products
// of a slightly rotated A with B on operands that sit in on-chip memory, 64
// identical programs, to read the matrix unit's rate as a function of N.
//
// On Hopper (2048, 512) bfloat16 does not fit an SM's 227 KB, so the probe
// tiles, walks K in slabs and, because the sums over r and over K commute,
// runs all `reps` products of a slab while it is on chip: each slab of A and
// B is read from device memory (mostly from L2) once per tile. Each launch
// repeats the whole tile grid `grid_reps` times (each repeat redoes the same
// work and writes the same values), so that a launch lasts long enough to
// time. What bounds it: operations (2 * M * K * N * reps against the bytes
// of one A, one B and one out).
//
// Route 1, mma.sync (m16n8k16 bf16, m16n8k32 s8, m16n8k8 tf32): a block of
// four warps (2 x 2) owns 64 rows of A and BN columns of B (BN the widest of
// 128, 64, 32 that divides N), loads chunks of 256 bytes of K of both into
// shared memory, in the K-major 128-byte-swizzle layout (rows of 128 bytes,
// row r's 16-byte unit u stored at unit u ^ (r % 8), one [rows][128 B] slab
// per 128 bytes of K: it keeps the fragment loads free of bank conflicts),
// and applies the rotation to each A fragment in registers.
//
// Route 2, wgmma.mma_async with A from registers (m64nBNk16 bf16, k32 s8, k8
// tf32; BN the widest of 256, 128, 64, 32 that divides N):
//
// - A persistent grid, one CTA per SM, walks the tiles of 128 rows x BN
//   columns, m fastest, then n, then the grid repeat (at (2048, 512, 512)
//   bfloat16 with BN 256: 32 tiles a repeat).
// - Warpgroup 0 is the producer: one thread issues, per 128-byte slab of K,
//   one TMA load of A (128 rows) and one of B (BN rows) in the 128-byte
//   swizzle into a ring of STAGES stages, each with a full barrier (TMA's
//   transaction count) and an empty barrier (one arrival per consumer); the
//   warpgroup gives its registers away (setmaxnreg).
// - Warpgroups 1 and 2 consume, each 64 rows of the tile: BN / 2 float32
//   (int32) accumulators a thread. A consumer loads its A fragment of a
//   slab once (ldmatrix.x4 through the swizzle: 16 words a thread, the
//   register-A layout of four k steps), then for each r forms round(A + r)
//   in registers (bf16: __hadd2, one rounding to nearest even; int8:
//   __vadd4, wrapping; TF32: the float32 add, then cvt.rna to TF32) and
//   issues the slab's four k steps on it, with B through a descriptor. No
//   rotated A is written to shared memory, so no proxy fence is needed.
// - Every (slab, r) is one commit group; the rotated fragment alternates
//   between two register sets, and each group ends in wait_group 1: the
//   group before it, which read the other set, is done before that set is
//   rewritten, and one group is always in flight while the next is formed.
//   A stage goes back to the producer once the last group that read it is
//   done.
// - TF32: the register form takes A rounded to TF32 by cvt.rna; B goes to
//   the tensor core as the float32 bits TMA stored, and the tensor core
//   reads them as TF32 (route 1 rounds B with cvt.rna as it stages it).
// - The epilogue writes the accumulators straight from registers, once per
//   tile and grid repeat, while the producer already loads the next tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_tile.cuh"
#include "tma_ops.cuh"
#include "wgmma_ops.cuh"

namespace {

constexpr int T_BF16 = 0, T_S8 = 1, T_TF32 = 2;
constexpr int BM = 64;         // rows of A per block (mma.sync route)
constexpr int NTHREADS = 128;  // four warps (mma.sync route)

template <int TYPE>
constexpr int ELEM_BYTES = TYPE == T_BF16 ? 2 : TYPE == T_S8 ? 1 : 4;

__device__ __forceinline__ uint32_t to_tf32(uint32_t f32_bits) {
  uint32_t out;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(out) : "f"(__uint_as_float(f32_bits)));
  return out;
}

// one 32-bit word of A plus r, rounded once in A's type
template <int TYPE>
__device__ __forceinline__ uint32_t rotate(uint32_t w, int r) {
  if constexpr (TYPE == T_BF16) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
    const __nv_bfloat16 rr = __int2bfloat16_rn(r);
    v = __hadd2(v, __nv_bfloat162(rr, rr));
    return *reinterpret_cast<uint32_t*>(&v);
  } else if constexpr (TYPE == T_S8) {
    return __vadd4(w, 0x01010101u * (uint32_t)(r & 0xff));
  } else {
    return to_tf32(__float_as_uint(__fadd_rn(__uint_as_float(w), (float)r)));
  }
}

// byte offset of (row, byte kb of the row) in a swizzled tile of `rows` rows
__device__ __forceinline__ uint32_t sw_off(int rows, int row, int kb) {
  return (uint32_t)(kb >> 7) * rows * 128 + row * 128 + ((((kb >> 4) & 7) ^ (row & 7)) << 4) +
         (kb & 15);
}

// copy `rows` rows of `rb` bytes (row stride ld bytes) into a swizzled tile
template <int TYPE, bool ROUND>
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* __restrict__ src,
                                          int rows, int rb, size_t ld, int lv) {
  const int vpr = rb >> 4;
  for (int v = threadIdx.x; v < rows * vpr; v += NTHREADS) {
    const int row = v >> lv, u = v & (vpr - 1);
    uint4 val = *reinterpret_cast<const uint4*>(src + (size_t)row * ld + u * 16);
    if (ROUND && TYPE == T_TF32)
      val = make_uint4(to_tf32(val.x), to_tf32(val.y), to_tf32(val.z), to_tf32(val.w));
    *reinterpret_cast<uint4*>(tile + sw_off(rows, row, u * 16)) = val;
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
}

template <int TYPE>
using acc_of = typename std::conditional<TYPE == T_S8, int, float>::type;

template <int TYPE>
__device__ __forceinline__ void store2(void* out, size_t at, acc_of<TYPE> v0, acc_of<TYPE> v1) {
  if constexpr (TYPE == T_BF16) {
    __nv_bfloat162 h;
    h.x = __float2bfloat16_rn(v0);
    h.y = __float2bfloat16_rn(v1);
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + at) = h;
  } else if constexpr (TYPE == T_S8) {
    *reinterpret_cast<int2*>(static_cast<int*>(out) + at) = make_int2(v0, v1);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + at) = make_float2(v0, v1);
  }
}

// ------------------------------------------------------------ mma.sync route

template <int TYPE>
__device__ __forceinline__ void mma_sync(acc_of<TYPE> (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (TYPE == T_BF16) {
    rdt::BF16::mma(d, a, b0, b1);
  } else if constexpr (TYPE == T_S8) {
    rdt::S8::mma(d, a, b0, b1);
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

template <int TYPE, int BN>
__global__ void __launch_bounds__(NTHREADS, 4)
mma_sync_rate_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
                     void* __restrict__ out, int N, int rb, int rb_total, size_t lda,
                     size_t ldb, int lv, int reps) {
  constexpr int NT = BN / 16;  // n8 tiles of one warp (BN / 2 columns)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = aligned_smem(smem_raw);
  uint8_t* bs = as + BM * rb;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  acc_of<TYPE> acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // K in chunks of rb bytes: each chunk of A and B is loaded once and serves
  // all `reps` products (the sums over r and over K commute)
#pragma unroll 1
  for (int k0 = 0; k0 < rb_total; k0 += rb) {
    __syncthreads();  // the previous chunk's reads are over
    load_tile<TYPE, false>(as, a + (size_t)m0 * lda + k0, BM, rb, lda, lv);
    load_tile<TYPE, true>(bs, bt + (size_t)n0 * ldb + k0, BN, rb, ldb, lv);
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
#pragma unroll 2
      for (int kb = 0; kb < rb; kb += 32) {  // one mma k-step is 32 bytes of K
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int row = 32 * wm + 16 * mt + g;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(as + sw_off(BM, row, kb + 4 * t));
          af[mt][1] = *reinterpret_cast<const uint32_t*>(as + sw_off(BM, row + 8, kb + 4 * t));
          af[mt][2] = *reinterpret_cast<const uint32_t*>(as + sw_off(BM, row, kb + 16 + 4 * t));
          af[mt][3] =
              *reinterpret_cast<const uint32_t*>(as + sw_off(BM, row + 8, kb + 16 + 4 * t));
#pragma unroll
          for (int e = 0; e < 4; ++e) af[mt][e] = rotate<TYPE>(af[mt][e], r);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = (BN / 2) * wn + 8 * nt + g;
          const uint32_t b0 =
              *reinterpret_cast<const uint32_t*>(bs + sw_off(BN, col, kb + 4 * t));
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(bs + sw_off(BN, col, kb + 16 + 4 * t));
          mma_sync<TYPE>(acc[0][nt], af[0], b0, b1);
          mma_sync<TYPE>(acc[1][nt], af[1], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int row = m0 + 32 * wm + 16 * mt + g;
      const int col = n0 + (BN / 2) * wn + 8 * nt + 2 * t;
      store2<TYPE>(out, (size_t)row * N + col, acc[mt][nt][0], acc[mt][nt][1]);
      store2<TYPE>(out, (size_t)(row + 8) * N + col, acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// --------------------------------------------------------------- wgmma route

namespace wg {
constexpr int BM = 128;       // rows of A per tile: 64 per consumer warpgroup
constexpr int SLAB = 128;     // bytes of K per ring stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;  // the producer warpgroup and two consumers
constexpr int A_BYTES = BM * SLAB;

constexpr int smem_bytes(int bn) { return 1024 + STAGES * (A_BYTES + bn * SLAB) + 2 * 8 * STAGES; }
}  // namespace wg

template <int TYPE, int BN>
__device__ __forceinline__ void wgmma_rs_step(acc_of<TYPE> (&d)[BN / 2], const uint32_t* a,
                                              uint64_t db) {
#define RDT_WG(n)                                                                        \
  if constexpr (BN == n) {                                                               \
    if constexpr (TYPE == T_BF16) rdt::wgmma_rs_bf16_n##n(d, a[0], a[1], a[2], a[3], db); \
    else if constexpr (TYPE == T_S8) rdt::wgmma_rs_s8_n##n(d, a[0], a[1], a[2], a[3], db); \
    else rdt::wgmma_rs_tf32_n##n(d, a[0], a[1], a[2], a[3], db);                         \
  }
  RDT_WG(32) RDT_WG(64) RDT_WG(128) RDT_WG(256)
#undef RDT_WG
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// keeps the compiler from moving a register's definition below, or its
// reads above, this point (a wgmma fence or wait beside it)
template <class T>
__device__ __forceinline__ void fence_operand(T& r) {
  if constexpr (std::is_same<T, float>::value) asm volatile("" : "+f"(r)::"memory");
  else asm volatile("" : "+r"(r)::"memory");
}

// tma: A (M, K) as a 2-d map, box (128 bytes of K, 128 rows); tmb: B^T (N,
// K), box (128 bytes of K, BN rows). Tile id -> m tile id % tiles_m, n tile
// (id % tiles_mn) / tiles_m, grid repeat id / tiles_mn.
template <int TYPE, int BN>
__global__ void __launch_bounds__(wg::THREADS, 1)
wgmma_rate_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmb,
                  void* __restrict__ out, int M, int N, int slabs, int reps, int tiles_m,
                  int tiles_mn, int n_tiles) {
  constexpr int CH = wg::SLAB / ELEM_BYTES<TYPE>;  // elements of K per slab
  constexpr int STAGE = wg::A_BYTES + BN * wg::SLAB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + wg::STAGES * STAGE);
  uint64_t* empty = full + wg::STAGES;
  const int wgi = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < wg::STAGES; ++s) {
      rdt::mbar_init(full + s, 1);
      rdt::mbar_init(empty + s, 2);
    }
    rdt::mbar_init_fence();
  }
  __syncthreads();

  if (wgi == 0) {  // ------------------------------------------------ producer
    rdt::setmaxnreg_dec<40>();
    if (tid != 0) return;
    rdt::tma_prefetch_desc(&tma);
    rdt::tma_prefetch_desc(&tmb);
    int st = 0, ph = 0;
    for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
      const int mn = id % tiles_mn, m0 = (mn % tiles_m) * wg::BM, n0 = (mn / tiles_m) * BN;
      for (int s = 0; s < slabs; ++s) {
        rdt::mbar_wait(empty + st, ph ^ 1);
        rdt::mbar_arrive_expect_tx(full + st, STAGE);
        uint8_t* dst = sm + st * STAGE;
        rdt::tma_load_2d(dst, &tma, full + st, s * CH, m0);
        rdt::tma_load_2d(dst + wg::A_BYTES, &tmb, full + st, s * CH, n0);
        if (++st == wg::STAGES) st = 0, ph ^= 1;
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  rdt::setmaxnreg_inc<232>();
  const int cw = wgi - 1, warp = tid >> 5, lane = tid & 31;
  // this lane's ldmatrix row of the stage's A tile (128-byte rows, 1024-byte
  // aligned, so the swizzle phase is the row's index mod 8) and its 16-byte
  // unit of each 32-byte k step
  const int arow = 64 * cw + 16 * warp + (lane & 15), unit = lane >> 4;
  const uint32_t sm_addr = rdt::smem_addr(sm);
  acc_of<TYPE> acc[BN / 2];
  uint32_t base[16], fr0[16], fr1[16];  // the slab's A; round(A + r), two sets
  int st = 0, ph = 0;
  const int groups = slabs * reps;

  for (int id = blockIdx.x; id < n_tiles; id += gridDim.x) {
    const int mn = id % tiles_mn, m0 = (mn % tiles_m) * wg::BM, n0 = (mn / tiles_m) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int r = 0, cur = -1, prev = -1;  // the slab's stage, the one before it
    // one (slab, r): the slab's A fragment when r == 0, round(A + r) into
    // `fr`, its four k steps as one commit group, then wait_group 1
    auto group = [&](uint32_t* fr) {
      if (r == 0) {
        rdt::mbar_wait(full + st, ph);
        const uint32_t a_row = sm_addr + st * STAGE + arow * 128;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          ldmatrix_x4(base + 4 * ks, a_row + (((2 * ks + unit) ^ (arow & 7)) << 4));
        prev = cur;
        cur = st;
        if (++st == wg::STAGES) st = 0, ph ^= 1;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        fr[i] = rotate<TYPE>(base[i], r);
        fence_operand(fr[i]);  // formed before the fence, not sunk past it
      }
      const uint32_t b_tile = sm_addr + cur * STAGE + wg::A_BYTES;
      rdt::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs_step<TYPE, BN>(acc, fr + 4 * ks, rdt::wgmma_desc_sw128(b_tile + 32 * ks));
      rdt::wgmma_commit();
      rdt::wgmma_wait<1>();  // the group before is done, and with it the other set
      if (r == 0 && prev >= 0 && tid == 0) rdt::mbar_arrive(empty + prev);
      if (++r == reps) r = 0;
    };
    // in pairs, so that on every path the set a group rewrites is the one
    // whose last reader the wait_group 1 before it has retired (a pair with
    // its second group under a condition made ptxas serialize the wgmmas)
    int gi = 0;
#pragma unroll 1
    for (; gi + 2 <= groups; gi += 2) {
      group(fr0);
      group(fr1);
    }
    if (gi < groups) group(fr0);
    rdt::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    if (tid == 0) rdt::mbar_arrive(empty + cur);

    // thread (warp, 4 g + t) holds rows 16 warp + g (+ 8) of this consumer's
    // 64, columns 8 j + 2 t (+ 1)
    const int g = lane >> 2, t = lane & 3, row = m0 + 64 * cw + 16 * warp + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (row < M) store2<TYPE>(out, (size_t)row * N + col, acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < M)
        store2<TYPE>(out, (size_t)(row + 8) * N + col, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

template <int TYPE, int BN>
cudaError_t launch_wgmma(const void* a, const void* bt, void* out, int M, int N, int K,
                         size_t sa, size_t sb, int reps, int grid_reps, int device,
                         cudaStream_t stream) {
  constexpr int ES = ELEM_BYTES<TYPE>;
  constexpr CUtensorMapDataType TT = TYPE == T_BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : TYPE == T_S8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tma, tmb;
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M}, astr[1] = {sa};
  const cuuint32_t abox[2] = {wg::SLAB / ES, wg::BM};
  cudaError_t err = rdt::encode_sw128(&tma, TT, 2, a, adims, astr, abox);
  if (err != cudaSuccess) return err;
  const cuuint64_t bdims[2] = {(cuuint64_t)K, (cuuint64_t)N}, bstr[1] = {sb};
  const cuuint32_t bbox[2] = {wg::SLAB / ES, BN};
  err = rdt::encode_sw128(&tmb, TT, 2, bt, bdims, bstr, bbox);
  if (err != cudaSuccess) return err;
  constexpr int smem = wg::smem_bytes(BN);
  static int configured = -1;  // the device whose attribute was set
  if (configured != device) {
    err = cudaFuncSetAttribute(wgmma_rate_kernel<TYPE, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = device;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles_m = (M + wg::BM - 1) / wg::BM, tiles_mn = tiles_m * (N / BN);
  const long long n_tiles = (long long)tiles_mn * grid_reps;
  if (n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  wgmma_rate_kernel<TYPE, BN><<<grid, wg::THREADS, smem, stream>>>(
      tma, tmb, out, M, N, K * ES / wg::SLAB, reps, tiles_m, tiles_mn, (int)n_tiles);
  return cudaGetLastError();
}

constexpr int SMEM_MAX = 232448;  // bytes a block may use on sm_90

// the mma.sync route's A and B chunks, and the slack to align to 1024 bytes
inline int smem_bytes(int rb, int bn) { return (BM + bn) * rb + 1024; }

template <class K>
cudaError_t launch(K kernel, int smem, dim3 grid, cudaStream_t stream, const uint8_t* a,
                   const uint8_t* bt, void* out, int N, int rb, int rb_total, size_t lda,
                   size_t ldb, int lv, int reps) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, stream>>>(a, bt, out, N, rb, rb_total, lda, ldb, lv, reps);
  return cudaGetLastError();
}

// bytes of K one pass of the mma.sync route holds in shared memory: small
// enough that several blocks share an SM
inline int chunk_bytes(int rb_total) { return rb_total < 256 ? rb_total : 256; }

}  // namespace

// The column width a launch would use, or 0 if the shape is not served:
// the widest of 256 (wgmma only), 128, 64, 32 that divides N and fits in
// shared memory.
extern "C" int rdt_mma_rate_bn(int N, int K, int dtype, int route) {
  const int es = dtype == T_BF16 ? 2 : dtype == T_S8 ? 1 : 4;
  const int rb = K * es;
  if (rb < 128 || (rb & (rb - 1)) != 0 || rb > 8192) return 0;
  for (int bn : {256, 128, 64, 32}) {
    const int smem = route == 0 ? smem_bytes(chunk_bytes(rb), bn) : wg::smem_bytes(bn);
    if ((route == 1 || bn != 256) && N % bn == 0 && smem <= SMEM_MAX) return bn;
  }
  return 0;
}

// a (M, K) with row stride lda elements, bt (N, K) with row stride ldb
// elements, out (M, N) contiguous: bfloat16 in and out (dtype 0), int8 in and
// int32 out (1), float32 in and out as TF32 products (2). route 0 = mma.sync,
// 1 = wgmma. M % 64 == 0 (the wgmma route's last tile of 128 rows reads
// zeros past M and stores nothing there); K * element size a power of two
// from 128 to 8192 bytes; a, bt and both strides 16-byte aligned.
extern "C" int rdt_mma_rate(const void* a, const void* bt, void* out, int M, int N, int K,
                            long long lda, long long ldb, int dtype, int route, int reps,
                            int grid_reps, int device, void* stream) {
  const int bn = (dtype < 0 || dtype > 2 || route < 0 || route > 1)
                     ? 0 : rdt_mma_rate_bn(N, K, dtype, route);
  if (bn == 0 || M % BM != 0 || reps < 1 || grid_reps < 1 || grid_reps > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int es = dtype == T_BF16 ? 2 : dtype == T_S8 ? 1 : 4;
  const int rb_total = K * es, rb = chunk_bytes(rb_total);
  int lv = 0;
  while ((16 << lv) < rb) ++lv;
  const int smem = smem_bytes(rb, bn);
  const dim3 grid(M / BM, N / bn, grid_reps);
  auto st = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const uint8_t*>(a);
  auto pb = static_cast<const uint8_t*>(bt);
  const size_t sa = (size_t)lda * es, sb = (size_t)ldb * es;
#define RDT_GO(kernel) \
  return launch(kernel, smem, grid, st, pa, pb, out, N, rb, rb_total, sa, sb, lv, reps)
#define RDT_SYNC(T)                                          \
  if (dtype == T) {                                          \
    if (bn == 128) RDT_GO((mma_sync_rate_kernel<T, 128>));   \
    if (bn == 64) RDT_GO((mma_sync_rate_kernel<T, 64>));     \
    RDT_GO((mma_sync_rate_kernel<T, 32>));                   \
  }
#define RDT_WG_GO(T, n) \
  return launch_wgmma<T, n>(pa, pb, out, M, N, K, sa, sb, reps, grid_reps, device, st)
#define RDT_WGM(T)                           \
  if (dtype == T) {                          \
    if (bn == 256) RDT_WG_GO(T, 256);        \
    if (bn == 128) RDT_WG_GO(T, 128);        \
    if (bn == 64) RDT_WG_GO(T, 64);          \
    RDT_WG_GO(T, 32);                        \
  }
  if (route == 0) {
    RDT_SYNC(T_BF16) RDT_SYNC(T_S8) RDT_SYNC(T_TF32)
  } else {
    RDT_WGM(T_BF16) RDT_WGM(T_S8) RDT_WGM(T_TF32)
  }
#undef RDT_GO
#undef RDT_SYNC
#undef RDT_WG_GO
#undef RDT_WGM
  return cudaErrorInvalidValue;
}
