"""Write ``wgmma_ops.cuh``: one inline-PTX wrapper per ``wgmma.mma_async``
shape the port uses. Each instruction names every accumulator register, so
the operand lists are mechanical; run ``python gen_wgmma_ops.py`` in this
directory after changing the shapes below and commit the header."""

from pathlib import Path

# (suffix, PTX type string, k, accumulator C type, constraint, trailing immediates)
TYPES = (
    ("bf16", "f32.bf16.bf16", 16, "float", "f", ", 1, 1, 0, 0"),
    ("tf32", "f32.tf32.tf32", 8, "float", "f", ", 1, 1"),
    ("s8", "s32.s8.s8", 32, "int", "r", ""),
)
WIDTHS = (32, 64, 128, 256)

HEAD = '''// Generated by gen_wgmma_ops.py: wgmma.mma_async wrappers (sm_90a only).
//
// Each computes D += A * B for a 64-row tile: A (64 x k) and B (k x N) are
// read from shared memory through 64-bit matrix descriptors (both K-major),
// D lives in the registers of the four warps of a warpgroup: thread (warp w,
// lane 4*g + t) holds, for j < N/8, d[4j], d[4j+1] = row 16w + g, columns
// 8j + 2t, 8j + 2t + 1 and d[4j+2], d[4j+3] = row 16w + g + 8, same columns.
// The caller fences before (wgmma_fence), commits and waits after.

#pragma once

#include <stdint.h>

namespace rdt {

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
}
// generic-proxy writes to shared memory become visible to the async proxy
// (wgmma's reads); follow it with a barrier among the writers and readers
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
}

// Descriptor of a K-major tile in the 128-byte-swizzle layout: rows of 128
// bytes, 8-row groups 1024 bytes apart, the 16-byte unit u of row r stored at
// unit u ^ (r % 8). `addr` is a shared-memory address inside a tile whose
// base is 1024-byte aligned; stepping 32 bytes along K adds 32 to it.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// The same layout read from any row of it: `addr` need not be 1024-byte
// aligned (a view that starts a whole number of 128-byte rows into the tile),
// and the 8-row groups are `group_bytes` apart, a multiple of 1024. The tile
// was stored with the swizzle of its absolute addresses (unit u of the row at
// address a goes to unit u ^ ((a / 128) % 8)), and the tensor core applies
// the same function of the address bits when it reads, so the descriptor's
// base-offset field stays 0: measured on an H100, setting it to the start's
// row phase gives wrong products, leaving it 0 gives the right ones.
__device__ __forceinline__ uint64_t wgmma_desc_sw128_rows(uint32_t addr, uint32_t group_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(group_bytes >> 4) << 32) |
         (1ull << 62);
}

'''


def wrapper(suffix, ptx, k, ctype, cons, imms, n):
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    ops = ", ".join(f'"+{cons}"(d[{i}])' for i in range(regs))
    return (
        f"__device__ __forceinline__ void wgmma_{suffix}_n{n}({ctype} (&d)[{regs}], "
        f"uint64_t da, uint64_t db) {{\n"
        f"  asm volatile(\n"
        f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k{k}.{ptx} "\n'
        f'      "{{{outs}}}, "\n'
        f'      "%{regs}, %{regs + 1}, p{imms};\\n}}\\n"\n'
        f"      : {ops}\n"
        f'      : "l"(da), "l"(db), "r"(1));\n'
        f"}}\n\n")


def main():
    body = "".join(wrapper(*t, n) for t in TYPES for n in WIDTHS)
    Path(__file__).with_name("wgmma_ops.cuh").write_text(HEAD + body + "}  // namespace rdt\n")


if __name__ == "__main__":
    main()
