"""Write ``wgmma_ops.cuh``: one inline-PTX wrapper per ``wgmma.mma_async``
shape the port uses, with A from shared memory (``wgmma_<type>_n<N>``) and
with A from registers (``wgmma_rs_<type>_n<N>``). Each instruction names every
accumulator register, so the operand lists are mechanical; run ``python
gen_wgmma_ops.py`` in this directory after changing the shapes below and
commit the header."""

from pathlib import Path

# (suffix, PTX type string, k, accumulator C type, constraint, trailing
# immediates with A from shared memory, the same with A from registers: the
# scales of A and B, then the transposes of A and B, where the type has them;
# the register form has no transpose of A)
TYPES = (
    ("bf16", "f32.bf16.bf16", 16, "float", "f", ", 1, 1, 0, 0", ", 1, 1, 0"),
    ("tf32", "f32.tf32.tf32", 8, "float", "f", ", 1, 1", ", 1, 1"),
    ("s8", "s32.s8.s8", 32, "int", "r", "", ""),
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
//
// The wgmma_rs_* forms read A from registers instead: four 32-bit words
// a0 .. a3 a thread, the mma.sync m16n8k{16,8,32} A fragment of 16 rows x 32
// bytes of K per warp, warp w holding rows 16w .. 16w + 15. By bytes of the
// k step: a0 = row 16w + g, bytes 4t .. 4t + 3; a1 = row 16w + g + 8, the
// same bytes; a2, a3 = the same two rows, bytes 16 + 4t .. 16 + 4t + 3 (what
// ldmatrix.x4 of the 16 x 32-byte slice gives). The registers must not
// change until a wait_group covers the instruction; fence (wgmma_fence)
// after writing them and before the instruction.

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

// The 64-byte-swizzle layout read the same way: rows of 64 bytes (32 bytes
// of K a step, two steps a row), 8-row groups `group_bytes` apart (512 in a
// dense tile), the 16-byte unit u of the row at address a stored at unit u ^
// ((a / 128) % 4), as TMA's 64-byte swizzle stores it; `addr` may start at
// any 64-byte row, the base-offset field 0 as above.
__device__ __forceinline__ uint64_t wgmma_desc_sw64_rows(uint32_t addr, uint32_t group_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(group_bytes >> 4) << 32) |
         (2ull << 62);
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


def wrapper_rs(suffix, ptx, k, ctype, cons, imms, n):
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    ops = ", ".join(f'"+{cons}"(d[{i}])' for i in range(regs))
    return (
        f"__device__ __forceinline__ void wgmma_rs_{suffix}_n{n}({ctype} (&d)[{regs}], "
        f"uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db) {{\n"
        f"  asm volatile(\n"
        f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 5}, 0;\\n"\n'
        f'      "wgmma.mma_async.sync.aligned.m64n{n}k{k}.{ptx} "\n'
        f'      "{{{outs}}}, "\n'
        f'      "{{%{regs}, %{regs + 1}, %{regs + 2}, %{regs + 3}}}, %{regs + 4}, p{imms};\\n}}\\n"\n'
        f"      : {ops}\n"
        f'      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));\n'
        f"}}\n\n")


def main():
    body = "".join(wrapper(*t[:6], n) for t in TYPES for n in WIDTHS)
    body += "".join(wrapper_rs(*t[:5], t[6], n) for t in TYPES for n in WIDTHS)
    Path(__file__).with_name("wgmma_ops.cuh").write_text(HEAD + body + "}  // namespace rdt\n")


if __name__ == "__main__":
    main()
