// K5: dense[m] = table[inv[m]], exact zeros where inv is outside [0, R).
//
// Replaces the TPU kernel radardistill_tpu/ops/pallas_expand.py
// (_expand_kernel, entered through expand_sorted_rows / expand_rows). On the
// TPU a row gather cost a fixed ~50-130 ns per row, so that kernel turned the
// gather into a one-hot matmul over a sorted 2-block window of the table,
// which needed a monotone inv per 512-cell block. Hopper has no such per-row
// wall: a row gather is a plain copy, so the window, the padding and the
// sortedness precondition are all gone and any inv is served.
//
// What bounds it on the H100: bytes. Each output row reads one table row and
// writes one dense row (at the conv4 handoff, 180^2 rows of 256 bf16 = 16.6 MB
// written, the occupied rows read), far below any compute limit. The design
// spends one warp per output row and moves the row in 16-byte vectors (the
// wrapper requires 16-byte rows and base pointers; every caller's rows are
// 256 or 512 channels wide), so consecutive lanes touch consecutive 16-byte
// words and every load and store is fully coalesced. The copy is of raw bits,
// so the result is bit-exact for every dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void expand_rows_kernel(const uint4* __restrict__ table,
                                   const int32_t* __restrict__ inv,
                                   uint4* __restrict__ out, int64_t n_rows_out,
                                   int64_t n_rows_table, int64_t vecs_per_row) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows_out) return;
  const int64_t src = inv[row];
  uint4* dst = out + row * vecs_per_row;
  if (src < 0 || src >= n_rows_table) {
    const uint4 zero{};
    for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = zero;
    return;
  }
  const uint4* s = table + src * vecs_per_row;
  for (int64_t v = lane; v < vecs_per_row; v += 32) dst[v] = s[v];
}

}  // namespace

extern "C" const char* rdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_bytes: a multiple of 16; table and out 16-byte aligned (the Python
// wrapper checks both).
extern "C" int rdt_expand_rows(const void* table, const int32_t* inv,
                               void* out, int64_t n_rows_out,
                               int64_t n_rows_table, int64_t row_bytes,
                               int device, void* stream) {
  if (row_bytes % 16 != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_rows_out == 0) return cudaGetLastError();
  const int64_t blocks = (n_rows_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  expand_rows_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), inv, static_cast<uint4*>(out),
      n_rows_out, n_rows_table, row_bytes / 16);
  return cudaGetLastError();
}
