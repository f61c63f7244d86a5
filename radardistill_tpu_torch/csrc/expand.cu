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
// written, the occupied rows read; at the teacher's entry, 2 x 1440^2 int8 rows
// of 32 bytes = 133 MB written), far below any compute limit. The design moves
// 16-byte vectors, one per thread, numbered row-major over the output (the
// wrapper requires 16-byte rows and base pointers), so consecutive lanes touch
// consecutive 16-byte words of the output whatever the row width, and the
// reads of one table row coalesce too. A row of 512 bytes takes one warp, a
// row of 32 bytes two lanes, and 16 such rows share a warp (a warp per row
// would leave 30 of 32 lanes idle on the teacher's 32-byte rows). The copy is
// of raw bits, so the result is bit-exact for every dtype.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void expand_rows_kernel(const uint4* __restrict__ table,
                                   const int32_t* __restrict__ inv,
                                   uint4* __restrict__ out, int64_t n_vecs_out,
                                   int64_t n_rows_table, int64_t vecs_per_row) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_vecs_out) return;
  const int64_t row = i / vecs_per_row, v = i - row * vecs_per_row;
  const int64_t src = inv[row];
  uint4 word{};
  if (src >= 0 && src < n_rows_table) word = table[src * vecs_per_row + v];
  out[i] = word;
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
  const int64_t vecs_per_row = row_bytes / 16;
  const int64_t n_vecs_out = n_rows_out * vecs_per_row;
  const int64_t blocks = (n_vecs_out + kThreads - 1) / kThreads;
  expand_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(table), inv, static_cast<uint4*>(out),
      n_vecs_out, n_rows_table, vecs_per_row);
  return cudaGetLastError();
}
