// P2: tensor-core rate probe with operands resident in shared memory.
//
//   out = sum over r < reps of  round_to_type(A + r) @ B
//
// A (M, K) and B (K, N) of one type: bfloat16 (float32 accumulation, bfloat16
// out), int8 (int32 accumulation, int32 out; A + r wraps as int8 addition
// does) or float32 run as TF32 products (operands rounded to TF32, float32
// accumulation and out). B arrives transposed, (N, K) with K contiguous.
//
// Replaces the TPU probe tools/mxu_rate.py (main.case, kern): eight products
// of a slightly rotated A with B on operands that sit in on-chip memory, 64
// identical programs, to read the matrix unit's rate as a function of N.
//
// On Hopper (2048, 512) bfloat16 does not fit an SM's 227 KB, so the probe
// tiles: a block owns 64 rows of A and BN columns of B (BN the widest of 256,
// 128, 64, 32 that divides N; 256 on the wgmma route only) and walks K in
// chunks of 256 bytes. It loads each chunk of both from device memory ONCE,
// runs all `reps` products of the chunk out of shared memory (the sums over r
// and over K commute), and writes its tile at the end. Small chunks let
// several blocks share an SM. The
// grid covers (M / 64, N / BN) and is repeated `grid_reps` times in z (each
// repeat redoes the same work and writes the same values), so that a launch
// lasts long enough to time. What bounds it: operations; the bytes are read
// once per block and are small beside 2 * 64 * K * BN * reps operations.
//
// Both routes use one shared-memory layout, the K-major 128-byte-swizzle tile
// that wgmma reads: rows of 128 bytes (64 bfloat16, 128 int8, 32 float32 of
// K), row r's 16-byte unit u stored at unit u ^ (r % 8), one such [rows][128 B]
// slab per 128 bytes of K. The swizzle is what keeps the fragment loads of the
// mma.sync route free of bank conflicts as well.
//
// Route 1, mma.sync (m16n8k16 bf16, m16n8k32 s8, m16n8k8 tf32): four warps as
// 2 x 2, a warp owns 32 rows by BN / 2 columns; A stays in shared memory
// unrotated and the rotation is applied to each fragment in registers.
//
// Route 2, wgmma.mma_async (m64nBNk16 bf16, k32 s8, k8 tf32): one warpgroup,
// A and B both read by the tensor core from shared memory through
// descriptors. The rotated A must therefore be materialised in shared memory
// for every r: a thread holds its part of the chunk of A in registers (8
// vectors of 16 bytes), and while round r's instructions run on one A tile
// the threads write round(A + r + 1) into a second one and fence the
// generic-proxy writes against the async proxy. The probe's rate includes
// whatever of the rewrite the products do not hide.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_tile.cuh"
#include "wgmma_ops.cuh"

namespace {

constexpr int T_BF16 = 0, T_S8 = 1, T_TF32 = 2;
constexpr int BM = 64;         // rows of A per block
constexpr int NTHREADS = 128;  // one warpgroup

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

template <int TYPE>
__device__ __forceinline__ uint4 rotate4(uint4 v, int r) {
  return make_uint4(rotate<TYPE>(v.x, r), rotate<TYPE>(v.y, r), rotate<TYPE>(v.z, r),
                    rotate<TYPE>(v.w, r));
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

template <int TYPE, int BN>
__device__ __forceinline__ void wgmma_step(acc_of<TYPE> (&d)[BN / 2], uint64_t da, uint64_t db) {
#define RDT_WG(n)                                                   \
  if constexpr (BN == n) {                                          \
    if constexpr (TYPE == T_BF16) rdt::wgmma_bf16_n##n(d, da, db);  \
    else if constexpr (TYPE == T_S8) rdt::wgmma_s8_n##n(d, da, db); \
    else rdt::wgmma_tf32_n##n(d, da, db);                           \
  }
  RDT_WG(32) RDT_WG(64) RDT_WG(128) RDT_WG(256)
#undef RDT_WG
}

// 16-byte vectors of a chunk of A a thread keeps in registers (64 * 256 / 16 / 128)
constexpr int NV = 8;

template <int TYPE, int BN>
__global__ void __launch_bounds__(NTHREADS, 2)
wgmma_rate_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
                  void* __restrict__ out, int N, int rb, int rb_total, size_t lda, size_t ldb,
                  int lv, int reps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* as = aligned_smem(smem_raw);  // two A tiles, then the B tile
  uint8_t* bs = as + 2 * BM * rb;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, vpr = rb >> 4, n_vec = BM * vpr;
  const int a_tile = BM * rb;

  acc_of<TYPE> acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const uint32_t as_addr = (uint32_t)__cvta_generic_to_shared(as);
  const uint32_t bs_addr = (uint32_t)__cvta_generic_to_shared(bs);

  // K in chunks of rb bytes: each chunk of A and B is loaded once and serves
  // all `reps` products (the sums over r and over K commute)
#pragma unroll 1
  for (int k0 = 0; k0 < rb_total; k0 += rb) {
    load_tile<TYPE, true>(bs, bt + (size_t)n0 * ldb + k0, BN, rb, ldb, lv);
    uint4 a0[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = tid + NTHREADS * i;
      a0[i] = make_uint4(0, 0, 0, 0);
      if (v < n_vec)
        a0[i] = *reinterpret_cast<const uint4*>(a + (size_t)(m0 + (v >> lv)) * lda + k0 +
                                                (v & (vpr - 1)) * 16);
    }

    // round r's products run on tile r % 2 while the threads write round
    // r + 1's rotated A into the other tile
    auto write_a = [&](int r) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = tid + NTHREADS * i;
        if (v < n_vec)
          *reinterpret_cast<uint4*>(as + (r & 1) * a_tile +
                                    sw_off(BM, v >> lv, (v & (vpr - 1)) * 16)) =
              rotate4<TYPE>(a0[i], r);
      }
      rdt::fence_proxy_async();
    };
    write_a(0);
    __syncthreads();
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
      const uint32_t ar_addr = as_addr + (r & 1) * a_tile;
      rdt::wgmma_fence();
#pragma unroll 1
      for (int kc = 0; kc < rb; kc += 128) {  // one 128-byte slab of K
#pragma unroll
        for (int ks = 0; ks < 128; ks += 32)  // one instruction: 32 bytes of K
          wgmma_step<TYPE, BN>(acc,
                                rdt::wgmma_desc_sw128(ar_addr + (kc >> 7) * BM * 128 + ks),
                                rdt::wgmma_desc_sw128(bs_addr + (kc >> 7) * BN * 128 + ks));
      }
      rdt::wgmma_commit();
      if (r + 1 < reps) write_a(r + 1);
      rdt::wgmma_wait_all();
      __syncthreads();  // the products are over and the next tile is written
    }
  }

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int row = m0 + 16 * warp + g, col = n0 + 8 * j + 2 * t;
    store2<TYPE>(out, (size_t)row * N + col, acc[4 * j], acc[4 * j + 1]);
    store2<TYPE>(out, (size_t)(row + 8) * N + col, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

constexpr int SMEM_MAX = 232448;  // bytes a block may use on sm_90

// A (two tiles on the wgmma route), B, and the slack to align to 1024 bytes
inline int smem_bytes(int rb, int bn, int route) {
  return ((route == 1 ? 2 : 1) * BM + bn) * rb + 1024;
}

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

// bytes of K one pass holds in shared memory: small enough that several
// blocks share an SM and, on the wgmma route, that a thread holds its part of
// the A chunk in registers beside the accumulators
inline int chunk_bytes(int rb_total) { return rb_total < 256 ? rb_total : 256; }

}  // namespace

// The column width a launch would use, or 0 if the shape is not served:
// the widest of 256 (wgmma only), 128, 64, 32 that divides N and fits beside
// the A tile.
extern "C" int rdt_mma_rate_bn(int N, int K, int dtype, int route) {
  const int es = dtype == T_BF16 ? 2 : dtype == T_S8 ? 1 : 4;
  const int rb = K * es;
  if (rb < 128 || (rb & (rb - 1)) != 0 || rb > 8192) return 0;
  for (int bn : {256, 128, 64, 32}) {
    if (bn == 256 && route == 0) continue;
    if (N % bn == 0 && smem_bytes(chunk_bytes(rb), bn, route) <= SMEM_MAX) return bn;
  }
  return 0;
}

// a (M, K) with row stride lda elements, bt (N, K) with row stride ldb
// elements, out (M, N) contiguous: bfloat16 in and out (dtype 0), int8 in and
// int32 out (1), float32 in and out as TF32 products (2). route 0 = mma.sync,
// 1 = wgmma. M % 64 == 0; K * element size a power of two from 128 to 8192
// bytes; a, bt and both strides 16-byte aligned.
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
  const int smem = smem_bytes(rb, bn, route);
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
#define RDT_WGM(T)                                                 \
  if (dtype == T) {                                                \
    if (bn == 256) RDT_GO((wgmma_rate_kernel<T, 256>));            \
    if (bn == 128) RDT_GO((wgmma_rate_kernel<T, 128>));            \
    if (bn == 64) RDT_GO((wgmma_rate_kernel<T, 64>));              \
    RDT_GO((wgmma_rate_kernel<T, 32>));                            \
  }
  if (route == 0) {
    RDT_SYNC(T_BF16) RDT_SYNC(T_S8) RDT_SYNC(T_TF32)
  } else {
    RDT_WGM(T_BF16) RDT_WGM(T_S8) RDT_WGM(T_TF32)
  }
#undef RDT_GO
#undef RDT_SYNC
#undef RDT_WGM
  return cudaErrorInvalidValue;
}
