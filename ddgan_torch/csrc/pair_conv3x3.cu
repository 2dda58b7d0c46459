// 3x3 stride-1 same-pad convolution plus bias for Hopper (sm_90a): NCHW
// bfloat16 input, OIHW bfloat16 weights with 64 output channels, float32
// bias, float32 accumulation, NCHW bfloat16 output.
//
// Replaces the Pallas TPU kernel `_pair_kernel`
// (ddgan_tpu/ops/experimental/pallas_conv.py:104, launched by
// `_pair_conv_raw` :139 for `pair_conv3x3` :189). That kernel viewed the
// input in pairs of columns so that 64 output channels filled the 128 lanes
// of the TPU's matrix unit (`_widen_weights`); here nothing needs widening,
// and the kernel computes the same function directly:
//
//   y[n, o, i, j] = bf16( b[o] + sum_{c, ky, kx} x[n, c, i+ky-1, j+kx-1] * w[o, c, ky, kx] )
//
// with x = 0 outside the image, every product and sum in float32, and one
// rounding to bfloat16 at the end (the bias is added in float32 first, as
// the TPU kernel starts its float32 accumulator from the bias).
//
// Bound: at the shapes of the 256x256 generator (C_in 64 or 128, 128x128 or
// 256x256 maps) the conv does 2*64*9*C_in flops per output pixel against
// 2*(C_in + 64) bytes moved, 290-370 flops per byte: near the H100's bf16
// balance point (989 TFLOP/s over 3.35 TB/s = 295), so tensor cores and
// memory both matter.
//
// Design: an implicit GEMM on the tensor cores, M = output pixels, N = 64
// output channels, K = 9 * C_in ordered (tap, channel). One block of 8 warps
// computes a 4 x 64 tile of output pixels for all 64 channels. The input
// channels go in chunks of 32: for each chunk the block stages its input
// tile with the 1-pixel halo (6 x 66 pixels) channel-innermost in shared
// memory, and the chunk's weights as [tap][out channel][in channel]. Each
// warp owns 32 pixels of one output row (two 16-row A tiles) by 64 channels
// (eight 8-column B tiles) and for each of the 9 taps and each 16-channel
// step loads its fragments with ldmatrix (a tap is a shift of the pixel
// rows in shared memory) and issues mma.sync m16n8k16 bf16 -> f32. Shared
// rows are padded to 40 elements (80 bytes) so ldmatrix reads no bank
// twice. The epilogue adds the bias, rounds once, stages the tile in shared
// memory as [channel][pixel] and writes each output row segment with
// 16-byte stores. No double buffering yet: two blocks per SM overlap one
// block's loads with the other's math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 64;
constexpr int kTH = 4;   // output rows per block
constexpr int kTW = 64;  // output columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCK = 32;        // input channels per chunk
constexpr int kLd = kCK + 8;   // shared row stride in elements (80 bytes)
constexpr int kInH = kTH + 2;  // input tile rows, with halo
constexpr int kInW = kTW + 2;  // input tile columns, with halo
constexpr int kInPix = kInH * kInW;
constexpr int kXElems = kInPix * kLd;
constexpr int kWElems = 9 * kCout * kLd;
constexpr int kOutLd = kTH * kTW + 8;  // staged output row stride (528 bytes)
constexpr size_t kSmemBytes = (size_t)(kXElems + kWElems) * sizeof(__nv_bfloat16);
static_assert(kCout * kOutLd <= kXElems + kWElems, "output staging must fit in shared memory");
static_assert(kWarps == 2 * kTH && kTW == 64, "warp layout: 2 warps of 32 pixels per row");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a * b, one m16n8k16 tile, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
pair_conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int C, int H,
                    int W, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_x = smem;           // [kInPix][kLd]: pixel-major, channel innermost
  __nv_bfloat16* s_w = smem + kXElems;  // [9 taps][kCout][kLd]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const size_t plane = (size_t)H * W;
  const __nv_bfloat16* xb = x + (size_t)n * C * plane;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.f, 0.f);

  // this warp's 32 pixels: output row wr of the tile, columns wc .. wc+31
  const int wr = warp >> 1;
  const int wc = (warp & 1) * 32;

  float acc[2][8][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCK) {
    const int valid = min(kCK, C - c0);  // even, since C is
    if (c0 > 0) __syncthreads();         // every warp is done with the last chunk

    // input tile with halo; a thread moves one pixel of two adjacent
    // channels, threads in a row of the image read adjacent columns
    for (int i = tid; i < (kCK / 2) * kInPix; i += kThreads) {
      const int cp = i / kInPix;
      const int pix = i - cp * kInPix;
      const int r = pix / kInW;
      const int col = pix - r * kInW;
      const int gy = y0 - 1 + r, gx = x0 - 1 + col;
      __nv_bfloat162 v = zero2;
      if (2 * cp < valid && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const __nv_bfloat16* p = xb + (size_t)(c0 + 2 * cp) * plane + (size_t)gy * W + gx;
        v.x = p[0];
        v.y = p[plane];
      }
      *reinterpret_cast<__nv_bfloat162*>(s_x + pix * kLd + 2 * cp) = v;
    }

    // weights of the chunk: for each output channel o the (channel, tap)
    // run is contiguous in OIHW; read it two elements at a time
    const int run = valid * 9;
    constexpr int kPairsPerO = kCK * 9 / 2;
    for (int i = tid; i < kCout * kPairsPerO; i += kThreads) {
      const int o = i / kPairsPerO;
      const int e = 2 * (i - o * kPairsPerO);
      __nv_bfloat162 v = zero2;
      if (e < run) {
        v = *reinterpret_cast<const __nv_bfloat162*>(w + ((size_t)o * C + c0) * 9 + e);
      }
      const int cl0 = e / 9, t0 = e - 9 * cl0;
      const int cl1 = (e + 1) / 9, t1 = e + 1 - 9 * cl1;
      s_w[(t0 * kCout + o) * kLd + cl0] = v.x;
      s_w[(t1 * kCout + o) * kLd + cl1] = v.y;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap - 3 * (tap / 3);
#pragma unroll
      for (int ks = 0; ks < kCK / 16; ++ks) {
        // A: rows = 16 pixels (shifted by the tap), cols = 16 channels
        uint32_t a[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int pix = (wr + ky) * kInW + wc + j * 16 + (lane & 15) + kx;
          ldmatrix_x4(a[j], s_x + pix * kLd + ks * 16 + (lane >> 4) * 8);
        }
        // B: two 8-channel output tiles per ldmatrix.x4
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          const int o = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(b, s_w + (tap * kCout + o) * kLd + ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16(acc[j][2 * np], a[j], b[0], b[1]);
            mma_bf16(acc[j][2 * np + 1], a[j], b[2], b[3]);
          }
        }
      }
    }
  }

  // epilogue: bias in f32, one rounding, staged as [channel][pixel]
  __syncthreads();
  __nv_bfloat16* s_out = smem;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int o = t * 8 + tig * 2;
    const float b0 = bias[o], b1 = bias[o + 1];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = wr * kTW + wc + j * 16 + g;
      s_out[o * kOutLd + m] = __float2bfloat16(acc[j][t][0] + b0);
      s_out[(o + 1) * kOutLd + m] = __float2bfloat16(acc[j][t][1] + b1);
      s_out[o * kOutLd + m + 8] = __float2bfloat16(acc[j][t][2] + b0);
      s_out[(o + 1) * kOutLd + m + 8] = __float2bfloat16(acc[j][t][3] + b1);
    }
  }
  __syncthreads();

  // each (channel, row) of the tile is 64 contiguous outputs: 8 16-byte stores
  constexpr int kSegs = kTW / 8;
  for (int i = tid; i < kCout * kTH * kSegs; i += kThreads) {
    const int seg = i % kSegs;
    const int r = (i / kSegs) % kTH;
    const int o = i / (kSegs * kTH);
    const int gx = x0 + seg * 8;
    if (gx < W) {  // W % 8 == 0: a segment is wholly inside or outside
      const uint4 v = *reinterpret_cast<const uint4*>(s_out + o * kOutLd + r * kTW + seg * 8);
      *reinterpret_cast<uint4*>(y + ((size_t)n * kCout + o) * plane + (size_t)(y0 + r) * W + gx) =
          v;
    }
  }
}

}  // namespace

// x: contiguous (n, c, h, w) bfloat16; wt: contiguous (64, c, 3, 3)
// bfloat16; bias: (64,) float32; y: contiguous (n, 64, h, w) bfloat16.
// c even, h % 4 == 0, w % 8 == 0; x, wt and y 16-byte aligned. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ddgan_pair_conv3x3(const void* x, const void* wt, const void* bias, void* y, int n,
                                  int c, int h, int w, void* stream) {
  if (n <= 0 || c <= 0 || (c & 1) || h <= 0 || w <= 0 || (h % kTH) || (w % 8) || n > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pair_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (w + kTW - 1) / kTW;
  const dim3 grid((unsigned)(tiles_x * (h / kTH)), (unsigned)n);
  pair_conv3x3_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), c, h, w, tiles_x);
  return (int)cudaGetLastError();
}
