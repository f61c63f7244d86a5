// K8: windowed row gather with an overflow count.
//
//   rows[m] = table[idx[m]]   if idx[m] is active (in [0, R)) and lies inside
//                             the window of its aligned block of 512 entries,
//             0               otherwise (exact zero rows)
//   overflow = number of active entries outside their block's window
//
// The window of a block: with row_min the least active index of the block
// (r_full if it has none), start = clip(row_min / 512, 0, r_full / 512 - n_win)
// and the window is [start * 512, (start + n_win) * 512). r_full is R padded
// as the TPU kernel pads its table (the wrapper computes it).
//
// Replaces the TPU kernel radardistill_tpu/ops/pallas_expand.py
// (_gather_win_kernel, entered through gather_rows_windowed) and its monitor
// window_overflow. On the TPU the window is what made a row gather affordable:
// n_win one-hot matmuls over table blocks chosen by a prefetched start. On
// Hopper the copy needs no window, so here the window is only the function to
// reproduce: entries outside it must come out as zero rows and be counted.
//
// What bounds it on the H100: bytes (idx read, the gathered rows read, the
// rows written), so the only limit is how many bytes are in flight. The
// design:
//   - A window block of 512 entries is split into slices of `slice_rows`
//     rows (slice_rows_for: 1024 16-byte vectors a slice where the row
//     allows), one CTA of 128 threads each, so even the smallest gather
//     launches hundreds of CTAs and the largest thousands.
//   - Every CTA finds its block's window start itself: one 16-byte load of
//     four indices a thread (2 KB, from L2 after the block's first CTA), one
//     warp-shuffle minimum, one __syncthreads. No pre-pass, nothing shared
//     across CTAs.
//   - Then each thread issues its 8 predicated 16-byte ld.global.nc loads
//     before its first store (st.global.cs, streaming, so the output does not
//     push the table out of L2). Vectors are numbered row-major over the
//     slice, so neighbouring lanes store neighbouring words at any width. The
//     row widths of the model (64, 128, 256, 512 bytes) are compile-time
//     instantiations, where a vector's row is a shift; any other multiple of
//     16 bytes takes the general instantiation, which divides.
//   - Each CTA counts the overflow of its own slice's entries while its loads
//     fly, so every entry is counted once. The count needs no zeroed output:
//     one 64-bit atomic a CTA adds (1 ticket, its count) to a scratch word
//     that the wrapper keeps per device and stream, issued before the CTA's
//     stores and read after them; the CTA that drew the last ticket writes
//     the sum to `count` and sets the scratch back to zero for the next
//     launch. One atomic carries both halves, so no fence orders them.
// The copy is of raw bits: bit-exact for every dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 512;      // entries per window block (the TPU kernel's BLK)
constexpr int kThreads = 128;  // 4 warps; 4 indices a thread cover a block
constexpr int kUnroll = 8;     // 16-byte loads a thread has in flight
constexpr int kChunk = kThreads * kUnroll;  // vectors a CTA moves per round
static_assert(kThreads * 4 == kBlk, "one 16-byte index load a thread covers the block");

struct Window {
  int32_t base;   // first row of the window
  uint32_t span;  // rows in the window
  __device__ bool holds(int32_t src, int n_rows_table) const {
    return src >= 0 && src < n_rows_table && (uint32_t)(src - base) < span;
  }
};

// Loads the block's 512 indices into s_idx (four a thread, kept in v) and
// returns the block's window. Contains the kernel's one __syncthreads before
// the copy.
__device__ __forceinline__ Window block_window(const int32_t* __restrict__ idx, int64_t e0,
                                               int32_t* s_idx, int32_t* s_red, int32_t (&v)[4],
                                               int n_rows_table, int r_full, int n_win) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* src = idx + e0 + 4 * tid;
  int4 q;
  if ((reinterpret_cast<uintptr_t>(idx) & 15) == 0) {
    q = __ldg(reinterpret_cast<const int4*>(src));
  } else {  // a view that starts off a 16-byte boundary
    q = make_int4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
  }
  reinterpret_cast<int4*>(s_idx)[tid] = q;
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  int32_t lo = r_full;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (v[j] >= 0 && v[j] < n_rows_table) lo = min(lo, v[j]);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
  if (lane == 0) s_red[warp] = lo;
  __syncthreads();
  lo = min(min(s_red[0], s_red[1]), min(s_red[2], s_red[3]));
  return {max(0, min(lo / kBlk, r_full / kBlk - n_win)) * kBlk, (uint32_t)n_win * kBlk};
}

// The active entries of this thread's four that lie in the slice [r0, r0 +
// rows) and outside the window.
__device__ __forceinline__ int32_t slice_overflow(const int32_t (&v)[4], const Window& w,
                                                  int r0, int rows, int n_rows_table) {
  int32_t over = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = 4 * threadIdx.x + j;
    over += (e >= r0 && e < r0 + rows && v[j] >= 0 && v[j] < n_rows_table &&
             (uint32_t)(v[j] - w.base) >= w.span);
  }
  return over;
}

// Sums the CTA's overflow (every thread calls it with its part) and adds
// (one ticket, the sum) to the scratch word in one atomic. Returns, in thread
// 0, the word before the add plus the sum: the tickets drawn before this CTA
// above, the count so far below.
__device__ __forceinline__ unsigned long long draw_ticket(int32_t over, int32_t* s_cnt,
                                                          unsigned long long* scratch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) over += __shfl_xor_sync(0xffffffffu, over, d);
  if (lane == 0) s_cnt[warp] = over;
  __syncthreads();
  if (tid != 0) return 0;
  const unsigned long long n = (uint32_t)(s_cnt[0] + s_cnt[1] + s_cnt[2] + s_cnt[3]);
  return atomicAdd(scratch, (1ull << 32) | n) + n;
}

// Thread 0 of the CTA that drew the last ticket writes the count and zeroes
// the scratch for the next launch.
__device__ __forceinline__ void finish_count(unsigned long long ticket,
                                             int32_t* __restrict__ count,
                                             unsigned long long* scratch) {
  if (threadIdx.x == 0 && (ticket >> 32) == gridDim.x - 1) {
    *count = (int32_t)(uint32_t)ticket;
    atomicExch(scratch, 0ull);
  }
}

// Rows of a window block that one CTA takes: the most rows, a power of two
// that divides kBlk, whose vectors fit one round of kChunk; one row where a
// row alone is more (the CTA then loops over rounds).
int slice_rows_for(int64_t vpr) {
  int rows = kBlk;
  while (rows > 1 && rows * vpr > kChunk) rows /= 2;
  return rows;
}

// VPR: 16-byte vectors a row, or 0 for the general instantiation (vpr_rt).
template <int VPR>
__global__ void __launch_bounds__(kThreads)
gather_win_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ idx,
                  uint4* __restrict__ out, int32_t* __restrict__ count,
                  unsigned long long* scratch, int64_t n_entries, int n_rows_table, int r_full,
                  int n_win, int vpr_rt, int slice_rows) {
  __shared__ __align__(16) int32_t s_idx[kBlk];
  __shared__ int32_t s_red[kThreads / 32], s_cnt[kThreads / 32];
  const int vpr = VPR ? VPR : vpr_rt;
  const int slices = kBlk / slice_rows;
  const int64_t e0 = (int64_t)(blockIdx.x / slices) * kBlk;
  unsigned long long ticket = 0;
  if (e0 < n_entries) {  // false only in the one CTA launched for no entries
    int32_t v[4];
    const Window w = block_window(idx, e0, s_idx, s_red, v, n_rows_table, r_full, n_win);
    const int r0 = (blockIdx.x % slices) * slice_rows;
    const int n_vec = slice_rows * vpr;
    uint4* __restrict__ dst = out + (e0 + r0) * vpr;
    for (int c0 = 0; c0 < n_vec; c0 += kChunk) {
      uint4 word[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = c0 + k * kThreads + threadIdx.x;
        const int row = i / vpr;  // a shift where VPR is a power of two
        const int32_t src = i < n_vec ? s_idx[r0 + row] : -1;
        word[k] = make_uint4(0u, 0u, 0u, 0u);
        if (w.holds(src, n_rows_table))
          word[k] = __ldg(table + (int64_t)src * vpr + (i - row * vpr));
      }
      if (c0 == 0)
        ticket = draw_ticket(slice_overflow(v, w, r0, slice_rows, n_rows_table), s_cnt, scratch);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int i = c0 + k * kThreads + threadIdx.x;
        if (i < n_vec) __stcs(dst + i, word[k]);
      }
    }
  } else {
    ticket = draw_ticket(0, s_cnt, scratch);
  }
  finish_count(ticket, count, scratch);
}

template <int VPR>
cudaError_t launch(const void* table, const int32_t* idx, void* out, int32_t* count,
                   unsigned long long* scratch, int64_t n_entries, unsigned grid,
                   int n_rows_table, int r_full, int n_win, int vpr, int slice_rows,
                   cudaStream_t stream) {
  gather_win_kernel<VPR><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), count, scratch, n_entries,
      n_rows_table, r_full, n_win, vpr, slice_rows);
  return cudaGetLastError();
}

}  // namespace

// table (R, row_bytes), idx (M,) int32 with M a multiple of 512 below 2^31,
// out (M, row_bytes), count one int32 (written, need not be zeroed), scratch
// one 8-byte word that is zero between launches on this stream (the kernel
// leaves it so). row_bytes is a multiple of 16; table and out are 16-byte
// aligned; r_full is a multiple of 512 and at least (n_win + 1) * 512. With
// M = 0 one CTA writes the count 0.
extern "C" int rdt_gather_rows_windowed(const void* table, const int32_t* idx, void* out,
                                        int32_t* count, unsigned long long* scratch,
                                        int64_t n_rows_out, int64_t n_rows_table, int64_t r_full,
                                        int n_win, int64_t row_bytes, int device, void* stream) {
  const int64_t vpr = row_bytes / 16;
  if (row_bytes % 16 != 0 || vpr < 1 || vpr > 4096 || n_rows_out % kBlk != 0 ||
      n_rows_out > 0x7fffffffLL || r_full % kBlk != 0 || r_full > 0x7fffffffLL || n_win < 1 ||
      r_full < (int64_t)(n_win + 1) * kBlk || n_rows_table > r_full)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int slice_rows = slice_rows_for(vpr);
  const int64_t grid = n_rows_out == 0 ? 1 : n_rows_out / kBlk * (kBlk / slice_rows);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r = (int)n_rows_table, rf = (int)r_full;
  switch (vpr) {  // the model's row widths, 64-512 bytes, compile-time
    case 4: return launch<4>(table, idx, out, count, scratch, n_rows_out, grid, r, rf, n_win, 4,
                             slice_rows, s);
    case 8: return launch<8>(table, idx, out, count, scratch, n_rows_out, grid, r, rf, n_win, 8,
                             slice_rows, s);
    case 16: return launch<16>(table, idx, out, count, scratch, n_rows_out, grid, r, rf, n_win,
                               16, slice_rows, s);
    case 32: return launch<32>(table, idx, out, count, scratch, n_rows_out, grid, r, rf, n_win,
                               32, slice_rows, s);
    default: return launch<0>(table, idx, out, count, scratch, n_rows_out, grid, r, rf, n_win,
                              (int)vpr, slice_rows, s);
  }
}
