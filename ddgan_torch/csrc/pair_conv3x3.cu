// 3x3 stride-1 same-pad convolution plus bias for Hopper (sm_90a): NCHW
// bfloat16 input, OIHW weights (float32 or bfloat16) with 64 output
// channels, optional float32 bias, float32 accumulation, NCHW bfloat16
// output.
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
// with x = 0 outside the image, x and w rounded to bfloat16, every product
// and sum in float32, and one rounding to bfloat16 at the end (the bias is
// added in float32 first, as the TPU kernel starts its float32 accumulator
// from the bias). With `flip` the kernel applies the VJP's weights: w is
// the forward conv's (64, 64, 3, 3) weight and the conv uses
// w[c, o, 2-ky, 2-kx] (spatial flip, in/out swap), as JAX's `_bwd` does.
//
// Bound: at the 256x256 generator's shapes (C_in 64 or 128, 128x128 or
// 256x256 maps) the conv does 2*64*9*C_in flops per output pixel against
// 2*(C_in + 64) bytes moved, 290-370 flops per byte: near the H100's bf16
// balance point (989 TFLOP/s over 3.35 TB/s = 295), so tensor cores and
// memory both matter.
//
// Design: an implicit GEMM with A and B swapped to fit NCHW,
//   y^T[o, p] = W[o, (tap, c)] . X[(tap, c), p],
// M = the 64 output channels (one wgmma m64), N = pixels, K = (tap, channel).
// For a fixed channel and tap the pixels of an image row are contiguous in
// NCHW, so B is the input itself, pixel-major (wgmma's transposed-B form),
// and the f32 accumulator is [channel][pixel], which the epilogue writes as
// NCHW rows.
//
//  * A persistent grid, one block per SM, walks over output tiles of
//    4 rows x 64 columns (all 64 output channels). A block packs the
//    weights once, at its start, into shared memory in the layout wgmma's
//    A operand wants (K-major, 128-byte swizzle, one 64x64 tile per tap and
//    64 input channels), rounding them to bf16 as JAX's w.astype(x.dtype)
//    and applying the VJP's flip on the way; the wrapper casts nothing.
//  * A stage of the ring is one 16-channel step of a tile: the 6 input rows
//    (4 + halo) x 64 columns, [row][channel][column] with the 128-byte
//    swizzle, for each of kx = 0, 1, 2, and the two 8-column halo blocks.
//    A producer warp loads the kx = 1 tile (columns x0 .. x0+63) and the
//    halo blocks with TMA (4-D tensor maps over x, dims (W, H, C, N);
//    completion on an mbarrier); TMA's out-of-bounds zero fill gives the
//    top, bottom and right pad and zeroes the channel tail when
//    C_in % 16 != 0. TMA cannot start a box at a column that is not a
//    multiple of 8 (it faults), so the kx = 0 and kx = 2 tiles, one column
//    to either side, are built from it in shared memory by a transform
//    warpgroup: each thread shifts one (row, channel) line by one column
//    with byte permutes, taking the end column from a halo block. A shift
//    in ky is a whole row of a tile: an offset of the B descriptor.
//  * Two consumer warpgroups each own two of the tile's rows (N = 128) and
//    run, per stage, nine wgmma m64n128k16 (the taps) with
//    bf16 x bf16 -> f32, keeping one stage's group in flight while they
//    hand the stage before it back to the producer.
//  * The epilogue adds the bias in f32, rounds once, transposes pairs of
//    pixels across each quad of lanes with shuffles and writes each 8-pixel
//    row segment with one 16-byte store (partial column tiles masked).
// The loads and shifts of the next stages overlap the math of this one; the
// producer and the transform run ahead into the next tile while the
// consumers store.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 64;
constexpr int kTileRows = 4;                      // output rows per tile
constexpr int kTileCols = 64;                     // output columns per tile: 128 bytes
constexpr int kCK = 16;                           // input channels per stage (one K step)
constexpr int kInRows = kTileRows + 2;            // input rows per stage, with halo
constexpr int kRowBytes = kCK * kTileCols * 2;    // 2048: one input row of a tile
constexpr int kTileBytes = kInRows * kRowBytes;   // 12288: the 6 rows at one kx
constexpr int kHaloCols = 8;                      // a TMA box starts on 8 columns
constexpr int kHaloBytes = kCK * kInRows * kHaloCols * 2;  // 1536: [channel][row][8]
// stage: [kx=1 (TMA)][kx=0][kx=2][left halo][right halo]
constexpr int kStageBytes = 3 * kTileBytes + 2 * kHaloBytes;  // 39936 = 39 KB
constexpr int kWTileBytes = kCout * 64 * 2;       // 8192: 64 out x 64 in channels, one tap
constexpr int kConsumers = 256;                   // warpgroups 0 and 1
constexpr int kShifters = 128;                    // warpgroup 2
constexpr int kThreads = kConsumers + kShifters + 32;  // and one producer warp
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kShifterWarps = kShifters / 32;
static_assert(kStageBytes % 1024 == 0, "swizzled tiles need 1024-byte alignment");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// returns once the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128]; A K-major, B N-major (trans-b)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

struct Tile {
  int n, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int row_groups, int col_tiles) {
  Tile r;
  r.x0 = (t % col_tiles) * kTileCols;
  t /= col_tiles;
  r.y0 = (t % row_groups) * kTileRows;
  r.n = t / row_groups;
  return r;
}

__global__ void __launch_bounds__(kThreads, 1)
pair_conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap halomap, const void* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int C, int H,
                    int W, int n_tiles, int row_groups, int col_tiles, int stages, int w_bf16,
                    int flip) {
  extern __shared__ unsigned char smem_raw[];
  // swizzled TMA destinations and wgmma operands need 1024-byte alignment
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s_base - smem_u32(smem_raw));
  const int k_atoms = (C + 63) / 64;       // 64-channel K tiles of the packed weights
  const int iters = (C + kCK - 1) / kCK;   // stages per tile
  const uint32_t w_bytes = 9u * k_atoms * kWTileBytes;
  const uint32_t s_w = s_base;
  const uint32_t s_x = s_base + w_bytes;
  // per stage: loaded (TMA), shifted (transform warps), empty (consumers)
  const uint32_t s_loaded = s_x + (uint32_t)stages * kStageBytes;
  const uint32_t s_shifted = s_loaded + 8u * stages;
  const uint32_t s_empty = s_shifted + 8u * stages;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(s_loaded + 8 * s, 1);
      mbar_init(s_shifted + 8 * s, kShifterWarps);
      mbar_init(s_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers + kShifters) {
    // producer: one thread keeps the ring full, from the first tile on
    if (tid == kConsumers + kShifters) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const Tile tl = tile_at(t, row_groups, col_tiles);
        const bool left = tl.x0 > 0, right = tl.x0 + kTileCols < W;
        const uint32_t bytes = kTileBytes + (left + right) * kHaloBytes;
        for (int it = 0; it < iters; ++it) {
          const uint32_t st = s_x + stage * kStageBytes, bar = s_loaded + 8 * stage;
          mbar_wait(s_empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(bar, bytes);
          for (int r = 0; r < kInRows; ++r)  // one box per row: [16 channels][64 columns]
            tma_load_4d(st + r * kRowBytes, &xmap, bar, tl.x0, tl.y0 - 1 + r, it * kCK, tl.n);
          if (left)
            tma_load_4d(st + 3 * kTileBytes, &halomap, bar, tl.x0 - kHaloCols, tl.y0 - 1,
                        it * kCK, tl.n);
          if (right)
            tma_load_4d(st + 3 * kTileBytes + kHaloBytes, &halomap, bar, tl.x0 + kTileCols,
                        tl.y0 - 1, it * kCK, tl.n);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers and transform warps: pack the weights once per block, while
  // the producer's first loads are in flight. Tile (tap, k) holds
  // W[o, 64k + c] at row o (128 bytes), 16-byte chunk (c / 8) ^ (o % 8).
  // A thread reads one (out, in) channel pair's 9 taps, contiguous in
  // OIHW (so a warp reads contiguous memory), and stores 9 bf16 values.
  {
    const int packers = kConsumers + kShifters;
    const int c_rows = flip ? kCout : C;  // the weight's second dim
    const float* wf = static_cast<const float*>(w);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    for (int i = tid; i < kCout * C; i += packers) {
      const int a = i / c_rows, b = i - a * c_rows;  // w[a, b, :, :]
      const int o = flip ? b : a, c = flip ? a : b;
      const size_t base = (size_t)i * 9;
      float v[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) v[t] = w_bf16 ? __bfloat162float(wb[base + t]) : wf[base + t];
      unsigned char* dst = smem + (c >> 6) * kWTileBytes + o * 128 +
                           ((((c & 63) >> 3) ^ (o & 7)) << 4) + (c & 7) * 2;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int tap = flip ? 8 - t : t;
        *reinterpret_cast<__nv_bfloat16*>(dst + tap * k_atoms * kWTileBytes) =
            __float2bfloat16_rn(v[t]);
      }
    }
    // input channels C .. 64 * k_atoms - 1 of the last K tile are zero
    const int pad = 64 * k_atoms - C;
    for (int i = tid; i < 9 * kCout * pad; i += packers) {
      const int c = C + i % pad, o = (i / pad) % kCout, tap = i / (pad * kCout);
      *reinterpret_cast<__nv_bfloat16*>(smem + (tap * k_atoms + (c >> 6)) * kWTileBytes +
                                        o * 128 + ((((c & 63) >> 3) ^ (o & 7)) << 4) +
                                        (c & 7) * 2) = __float2bfloat16_rn(0.f);
    }
  }
  // the generic-proxy stores must be visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers + kShifters) : "memory");

  if (tid >= kConsumers) {
    // transform: the kx = 0 and kx = 2 tiles, the kx = 1 tile shifted by one
    // column either way. Thread (row r, channel c) owns one 64-column line;
    // its 16-byte chunk q lies at chunk q ^ (c % 8) of the line (swizzle).
    const int i = tid - kConsumers;
    const int r = i >> 4, c = i & 15;
    const int lane = tid & 31;
    const uint32_t line = r * kRowBytes + c * 128;
    const int key = c & 7;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, row_groups, col_tiles);
      const bool left = tl.x0 > 0, right = tl.x0 + kTileCols < W;
      for (int it = 0; it < iters; ++it) {
        mbar_wait(s_loaded + 8 * stage, phase);
        if (i < kInRows * kCK) {
          unsigned char* st = smem + (s_x - s_base) + stage * kStageBytes;
          const unsigned char* halo = st + 3 * kTileBytes + (c * kInRows + r) * 16;
          // u[k]: columns 2k, 2k+1 of the line (low, high half)
          uint32_t u[34];
          u[0] = left ? (uint32_t)(*reinterpret_cast<const uint16_t*>(halo + 14)) << 16 : 0u;
          u[33] = right ? (uint32_t)(*reinterpret_cast<const uint16_t*>(halo + kHaloBytes)) : 0u;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const uint4 v = *reinterpret_cast<const uint4*>(st + line + ((q ^ key) << 4));
            u[1 + 4 * q] = v.x;
            u[2 + 4 * q] = v.y;
            u[3 + 4 * q] = v.z;
            u[4 + 4 * q] = v.w;
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            // kx = 0: columns x0-1+j; word k = (hi of column word k-1, lo of k)
            uint4 a, b;
            a.x = __byte_perm(u[4 * q], u[4 * q + 1], 0x5432);
            a.y = __byte_perm(u[4 * q + 1], u[4 * q + 2], 0x5432);
            a.z = __byte_perm(u[4 * q + 2], u[4 * q + 3], 0x5432);
            a.w = __byte_perm(u[4 * q + 3], u[4 * q + 4], 0x5432);
            // kx = 2: columns x0+1+j; word k = (hi of word k, lo of word k+1)
            b.x = __byte_perm(u[4 * q + 1], u[4 * q + 2], 0x5432);
            b.y = __byte_perm(u[4 * q + 2], u[4 * q + 3], 0x5432);
            b.z = __byte_perm(u[4 * q + 3], u[4 * q + 4], 0x5432);
            b.w = __byte_perm(u[4 * q + 4], u[4 * q + 5], 0x5432);
            *reinterpret_cast<uint4*>(st + kTileBytes + line + ((q ^ key) << 4)) = a;
            *reinterpret_cast<uint4*>(st + 2 * kTileBytes + line + ((q ^ key) << 4)) = b;
          }
        }
        // the generic-proxy stores must be visible to wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) mbar_arrive(s_shifted + 8 * stage);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = tid >> 7;  // rows 2wg, 2wg+1 of the tile
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int o_lo = warp * 16 + (lane >> 2);  // accumulator rows o_lo and o_lo + 8
  const float bias_lo = bias ? bias[o_lo] : 0.f;
  const float bias_hi = bias ? bias[o_lo + 8] : 0.f;
  const size_t plane = (size_t)H * W;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, row_groups, col_tiles);
    int prev = 0;
    for (int it = 0; it < iters; ++it) {
      mbar_wait(s_shifted + 8 * stage, phase);
      wgmma_fence();
      const uint32_t a0 = s_w + (it >> 2) * kWTileBytes + (it & 3) * 32;
      const uint32_t b0 = s_x + stage * kStageBytes + 2 * wg * kRowBytes;
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const uint32_t bk = b0 + (kx == 1 ? 0 : kx == 0 ? kTileBytes : 2 * kTileBytes);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const uint64_t da = make_desc(a0 + (ky * 3 + kx) * k_atoms * kWTileBytes, 16, 1024);
          const uint64_t db = make_desc(bk + ky * kRowBytes, kRowBytes, 1024);
          wgmma_m64n128k16(acc, da, db, (it > 0 || kx > 0 || ky > 0) ? 1 : 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one is read: hand it back
      if (it > 0 && lane == 0) mbar_arrive(s_empty + 8 * prev);
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(s_empty + 8 * prev);

    // epilogue: acc[4k + 2h + e] is channel o_lo + 8h, pixel 8k + 2q + e of
    // the warpgroup's 128 (two rows of 64). Four lanes of a quad hold one
    // 8-pixel segment between them; a 4x4 exchange gives each lane one
    // segment of 4 pairs, stored with 16 bytes.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float bo = h ? bias_hi : bias_lo;
      __nv_bfloat16* yo = y + ((size_t)tl.n * kCout + o_lo + 8 * h) * plane;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t v[4], out[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * g + j;
          v[j] = pack_bf16x2(acc[4 * k + 2 * h] + bo, acc[4 * k + 2 * h + 1] + bo);
          out[j] = 0;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // lane q sends its pair of segment (q + r) % 4 to lane (q + r) % 4,
          // and gets the pair (q - r) % 4 of its own segment q
          const uint32_t got =
              __shfl_sync(0xffffffffu, pick(v, (q + r) & 3), (lane & ~3) | ((q - r) & 3));
          const int d = (q - r) & 3;
#pragma unroll
          for (int j = 0; j < 4; ++j) out[j] = (j == d) ? got : out[j];
        }
        const int k = 4 * g + q;  // this lane's segment
        const int row = tl.y0 + 2 * wg + (k >> 3);
        const int col = tl.x0 + (k & 7) * 8;
        if (col < W) {  // W % 8 == 0: a segment is wholly inside or outside
          *reinterpret_cast<uint4*>(yo + (size_t)row * W + col) =
              make_uint4(out[0], out[1], out[2], out[3]);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: look it up at run time, so the
// library needs no link against libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

}  // namespace

// Errors above CUDA's own codes: no cuTensorMapEncodeTiled entry point
// (10001), or it refused the tile map (20000 + its CUresult) or the halo
// map (30000 + its CUresult).
constexpr int kErrNoEncoder = 10001;
constexpr int kErrTileMap = 20000;
constexpr int kErrHaloMap = 30000;

// x: contiguous (n, c, h, w) bfloat16, 16-byte aligned. wt: contiguous OIHW,
// float32 (w_bf16 = 0) or bfloat16 (1): (64, c, 3, 3), or with `flip` the
// forward weight (c, 64, 3, 3) of the conv whose input gradient this is
// (then c == 64). bias: (64,) float32 or null (zero bias). y: contiguous
// (n, 64, h, w) bfloat16, 16-byte aligned. c even and <= 128, h % 4 == 0,
// w % 8 == 0. `stages` (ring depth), `smem_bytes` and `grid` come from the
// launch plan of ops/pair_conv.py. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or an error above 10000.
extern "C" int ddgan_pair_conv3x3(const void* x, const void* wt, const void* bias, void* y, int n,
                                  int c, int h, int w, int w_bf16, int flip, int stages,
                                  int smem_bytes, int grid, void* stream) {
  if (n <= 0 || c <= 0 || (c & 1) || c > 128 || h <= 0 || w <= 0 || (h % kTileRows) ||
      (w % 8) || (flip && c != kCout) || stages < 2 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const int k_atoms = (c + 63) / 64;
  if (smem_bytes < 1024 + 9 * k_atoms * kWTileBytes + stages * (kStageBytes + 24))
    return (int)cudaErrorInvalidValue;
  // a runtime call first: it makes the device's context current on this
  // thread (autograd's backward runs on a thread of its own), which the
  // tensor-map encoder (libcuda) needs
  cudaError_t err = cudaFuncSetAttribute(
      pair_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;

  // dims (W, H, C, N) in memory order. xmap: one input row of 16 channels x
  // 64 columns, [channel][column], 128-byte swizzled; halomap: 8 columns x
  // 6 rows x 16 channels, [channel][row][column].
  const cuuint64_t dims[4] = {(cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)c, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)w * 2, (cuuint64_t)h * w * 2,
                                 (cuuint64_t)c * h * w * 2};
  const cuuint32_t box[4] = {kTileCols, 1, kCK, 1};
  const cuuint32_t halo_box[4] = {kHaloCols, kInRows, kCK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUtensorMap map, halomap;
  CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kErrTileMap + (int)res;
  res = encode(&halomap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
               halo_box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return kErrHaloMap + (int)res;

  const int row_groups = h / kTileRows;
  const int col_tiles = (w + kTileCols - 1) / kTileCols;
  const int n_tiles = n * row_groups * col_tiles;
  pair_conv3x3_kernel<<<grid, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      map, halomap, wt, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), c, h, w,
      n_tiles, row_groups, col_tiles, stages, w_bf16, flip);
  return (int)cudaGetLastError();
}
