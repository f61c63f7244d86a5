// P1: the conv probes. One kernel family, three modes, on an input that the
// caller pre-padded by one zero row above and below, xp (B, H + 2, W, C), and
// a weight k (3, 3, C, Co):
//
//   conv  out[b, h, w] = sum over (ky, kx) of xp[b, h + ky, w + kx - 1] @ k[ky, kx]
//         (columns outside [0, W) read zero): the 3x3 stride-1 pad-1 conv;
//         bfloat16 products, float32 accumulation, bfloat16 out
//   dots  out[b, h, w] = sum over the nine taps t of xp[b, h, w] @ k[t]: the
//         same nine products with no shifted views; same types
//   int8  the nine products of dots in int8 -> int32, then
//         y = acc * a[co], relu if asked, and
//         clip(round_half_even(y * 0.37) - 127, -127, 127) as int8
//
// Replaces the TPU probes of tools/pallas_conv_proto.py: conv stands for
// conv3x3_pallas (_kernel), _kernel_k1152 (one im2col product) and
// conv3x3_shiftout (one wide product, shifted adds); dots for _kernel_dots,
// _kernel_n512, _kernel_tree and _kernel_tdot; int8 for _kernel_int8 (with
// relu) and _kernel_int8_n512 (without). The variants inside one mode differ
// only in how the TPU's compiler schedules the same sums on its matrix unit;
// on this card they are one function and one kernel.
//
// (The second route, with wgmma, is the conv mainloop of csrc/conv3x3_wgmma.cu.)
//
// The three modes share one load path, the tiled loop of csrc/conv_tile.cuh
// that K6, K9 and K1's streamed variant run: a block of 256 threads owns 8 x 16
// pixels by 128 output channels, stages the weight slice and the input tile
// with its halo in shared memory per chunk of input channels, and runs
// mma.sync from there. In dots and int8 mode every tap reads the tile's
// centre view, so the staging (halo included) is the same and only the
// shifted addressing goes. That is what makes their times subtractable:
// conv - dots is the cost of the nine shifted views, dots against the rate
// probe (csrc/mma_rate.cu) at the same N is the cost of streaming the
// activation and restaging the weight, int8 against dots is what the int8
// tensor cores buy at the conv's shape, Co 512 against 128 is the effect of a
// wider N. What bounds it: operations (2 * 9 * C * Co per pixel against
// 2 * (C + Co) bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_tile.cuh"

namespace {

constexpr int NT = 8;          // 128 output channels per block
constexpr int COT = 16 * NT;

// the int8 mode's epilogue; every float operation rounds once, as the plain
// version's does
__device__ __forceinline__ signed char quantize(int acc, float a, int relu) {
  float y = __fmul_rn((float)acc, a);
  if (relu) y = fmaxf(y, 0.0f);
  const float v = __fsub_rn(rintf(__fmul_rn(y, 0.37f)), 127.0f);
  return (signed char)fminf(fmaxf(v, -127.0f), 127.0f);
}

// SHIFT: conv (true) or dots. The int8 kernel quantizes in its epilogue.
template <class T, bool SHIFT>
__global__ void __launch_bounds__(rdt::NTHREADS, 2)
conv_probe_kernel(const typename T::elem* __restrict__ xp, const typename T::elem* __restrict__ k,
                  const float* __restrict__ a, typename T::elem* __restrict__ out, int B, int H,
                  int W, int C, int Co, int relu, int kcw) {
  extern __shared__ __align__(16) uint32_t smem_u[];
  const int n_cot = Co / COT;
  const int cot = blockIdx.x % n_cot, tile = blockIdx.x / n_cot;
  const int tiles_x = (W + rdt::TW - 1) / rdt::TW, tiles_y = (H + rdt::TH - 1) / rdt::TH;
  const int b = tile / (tiles_y * tiles_x);
  const int y0 = ((tile / tiles_x) % tiles_y) * rdt::TH, x0 = (tile % tiles_x) * rdt::TW;
  const int co0 = cot * COT;

  typename T::acc_t acc[2][NT][4];
  // the input is pre-padded in H: row_off 1, padded height H + 2
  rdt::conv_tile<T, NT, 3, SHIFT>(acc, xp, k, smem_u, b, y0, x0, co0, H + 2, 1, W, C, Co, kcw,
                                  0u);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int yy = y0 + 2 * wm + mt;
    if (yy >= H) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xx = x0 + g + 8 * half;
      if (xx >= W) continue;
      const size_t pix = ((size_t)b * H + yy) * W + xx;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = co0 + wn * 8 * NT + nt * 8 + 2 * t;
        if constexpr (std::is_same<T, rdt::BF16>::value) {
          __nv_bfloat162 h;
          h.x = __float2bfloat16_rn(acc[mt][nt][2 * half]);
          h.y = __float2bfloat16_rn(acc[mt][nt][2 * half + 1]);
          *reinterpret_cast<__nv_bfloat162*>(out + pix * Co + co) = h;
        } else {
          *reinterpret_cast<char2*>(out + pix * Co + co) =
              make_char2(quantize(acc[mt][nt][2 * half], __ldg(a + co), relu),
                         quantize(acc[mt][nt][2 * half + 1], __ldg(a + co + 1), relu));
        }
      }
    }
  }
}

template <class T, bool SHIFT>
cudaError_t launch(const void* xp, const void* k, const float* a, void* out, int B, int H, int W,
                   int C, int Co, int relu, cudaStream_t stream) {
  using E = typename T::elem;
  const int cw = C / T::CPW;
  const int kcw = cw % 16 == 0 ? 16 : 8;
  const int smem = 4 * rdt::tile_smem_words(3, kcw, COT);
  cudaError_t err = cudaFuncSetAttribute(
      conv_probe_kernel<T, SHIFT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * ((H + rdt::TH - 1) / rdt::TH) *
                           ((W + rdt::TW - 1) / rdt::TW) * (Co / COT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  conv_probe_kernel<T, SHIFT><<<(int)blocks, rdt::NTHREADS, smem, stream>>>(
      static_cast<const E*>(xp), static_cast<const E*>(k), a, static_cast<E*>(out), B, H, W, C,
      Co, relu, kcw);
  return cudaGetLastError();
}

}  // namespace

// xp (B, H + 2, W, C) and k (3, 3, C, Co) contiguous and 16-byte aligned, out
// (B, H, W, Co). mode 0 = conv, 1 = dots (both bfloat16 in and out, a unused),
// 2 = int8 (int8 in and out, a (Co,) float32). C a multiple of 16 (bfloat16)
// or 32 (int8) channels, Co a multiple of 128.
extern "C" int rdt_conv_probe(const void* xp, const void* k, const void* a, void* out, int B,
                              int H, int W, int C, int Co, int mode, int relu, int device,
                              void* stream) {
  if (mode < 0 || mode > 2 || Co % COT != 0 || C % (mode == 2 ? 32 : 16) != 0 ||
      (mode == 2 && a == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((long long)B * H * W == 0) return cudaGetLastError();
  auto st = static_cast<cudaStream_t>(stream);
  auto as = static_cast<const float*>(a);
  if (mode == 0) return launch<rdt::BF16, true>(xp, k, as, out, B, H, W, C, Co, 0, st);
  if (mode == 1) return launch<rdt::BF16, false>(xp, k, as, out, B, H, W, C, Co, 0, st);
  return launch<rdt::S8, false>(xp, k, as, out, B, H, W, C, Co, relu, st);
}
