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
// rows written). One block of 256 threads serves one block of 512 entries:
// it loads the 512 indices into shared memory, reduces their active minimum
// (warp shuffles, then one word per warp), counts the overflow in the same
// pass (one atomicAdd per block, and only when the count is not zero), then
// copies 16-byte vectors, numbered row-major over the block's output as in
// K5, so neighbouring lanes write neighbouring words whatever the row width.
// The copy is of raw bits: bit-exact for every dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 512;      // entries per window block (the TPU kernel's BLK)
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_win_kernel(const uint4* __restrict__ table, const int32_t* __restrict__ idx,
                  uint4* __restrict__ out, int32_t* __restrict__ overflow,
                  int n_rows_table, int r_full, int n_win, int vecs_per_row) {
  __shared__ int32_t s_idx[kBlk];
  __shared__ int32_t s_red[kThreads / 32];
  __shared__ int32_t s_start;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t e0 = (int64_t)blockIdx.x * kBlk;

  int32_t lo = r_full;
  for (int i = tid; i < kBlk; i += kThreads) {
    const int32_t v = idx[e0 + i];
    s_idx[i] = v;
    if (v >= 0 && v < n_rows_table) lo = min(lo, v);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
  if (lane == 0) s_red[warp] = lo;
  __syncthreads();
  if (tid == 0) {
    int32_t m = s_red[0];
    for (int w = 1; w < kThreads / 32; ++w) m = min(m, s_red[w]);
    s_start = max(0, min(m / kBlk, r_full / kBlk - n_win));
  }
  __syncthreads();
  const int32_t base = s_start * kBlk, span = n_win * kBlk;

  int32_t over = 0;
  for (int i = tid; i < kBlk; i += kThreads) {
    const int32_t v = s_idx[i];
    over += (v >= 0 && v < n_rows_table && v - base >= span) ? 1 : 0;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) over += __shfl_xor_sync(0xffffffffu, over, d);
  if (lane == 0 && over) atomicAdd(overflow, over);

  const uint4* __restrict__ tab = table;
  uint4* __restrict__ dst = out + e0 * vecs_per_row;
  const int n_vecs = kBlk * vecs_per_row;
  for (int i = tid; i < n_vecs; i += kThreads) {
    const int row = i / vecs_per_row, v = i - row * vecs_per_row;
    const int32_t src = s_idx[row];
    const int32_t rel = src - base;
    uint4 word{};
    if (src >= 0 && src < n_rows_table && rel >= 0 && rel < span)
      word = tab[(int64_t)src * vecs_per_row + v];
    dst[i] = word;
  }
}

}  // namespace

// table (R, row_bytes), idx (M,) int32 with M a multiple of 512, out
// (M, row_bytes), overflow one int32 that the caller zeroed. row_bytes is a
// multiple of 16; table and out are 16-byte aligned; r_full is a multiple of
// 512 and at least (n_win + 1) * 512 (the wrapper checks all of it).
extern "C" int rdt_gather_rows_windowed(const void* table, const int32_t* idx, void* out,
                                        int32_t* overflow, int64_t n_rows_out,
                                        int64_t n_rows_table, int64_t r_full, int n_win,
                                        int64_t row_bytes, int device, void* stream) {
  if (row_bytes % 16 != 0 || n_rows_out % kBlk != 0 || r_full % kBlk != 0 || n_win < 1 ||
      r_full < (int64_t)(n_win + 1) * kBlk || r_full > 0x7fffffffLL ||
      n_rows_table > r_full || row_bytes / 16 > 4096)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows_out == 0) return cudaGetLastError();
  const int64_t blocks = n_rows_out / kBlk;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_win_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), idx, static_cast<uint4*>(out), overflow,
      (int)n_rows_table, (int)r_full, n_win, (int)(row_bytes / 16));
  return cudaGetLastError();
}
