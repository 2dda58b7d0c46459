// Separable 4-tap FIR resampling by 2 for Hopper (sm_90a): the down2x and
// up2x patterns of upfirdn2d, on NCHW planes of float or bfloat16.
//
// Replaces the Pallas TPU kernel `_sep_mxu_kernel`
// (ddgan_tpu/ops/experimental/pallas_upfirdn.py:56, launched by
// `_sep_mxu_pallas` :75 for `down2x` :133 and `up2x` :158). That kernel
// computed out = Mh . X . Mw^T with banded matrices so the TPU's matrix
// unit could do the work; Mh and Mw are mostly zeros, and here the op is
// bound by memory (a few flops per byte), so these kernels compute the
// direct polyphase stencil instead:
//
//   down2x: upfirdn2d(up=1, down=2, pad=(1,1)), out = in / 2 per axis,
//           out[o] = sum_t kf[t] * x[2o - 1 + t]            (4 taps)
//   up2x:   upfirdn2d(up=2, down=1, pad=(2,1)), out = 2 * in per axis,
//           out[2m]   = kf[0] * x[m-1] + kf[2] * x[m]       (2 taps)
//           out[2m+1] = kf[1] * x[m]   + kf[3] * x[m+1]
//
// with kf the flipped taps (true convolution, as `_fir_matrix` builds the
// band matrices) and x = 0 outside the plane. The 2-D kernel is
// outer(k, k), so each output is a row pass followed by a column pass.
// Accumulation is in f32 for both types.
//
// down2x is a streaming stencil in registers. A group of adjacent lanes
// covers one output row strip of a plane: lane j owns outputs 4j..4j+3, so
// input columns 8j..8j+7, read with one 16-byte load in bf16 or two in f32;
// the one-column halo on each side comes from the neighbouring lane by warp
// shuffle (or, at a warp's edge, one narrow load). The lane walks down a
// segment of output rows and keeps the row pass of the last two input rows
// in registers, so each output row costs two new input rows, and writes its
// 4 outputs with one vector store. No shared memory, no block barrier: each
// input byte is read from DRAM once, and the two halo rows at a segment's
// start come again from L2. Groups are a power of two lanes (a multiple of
// 32 for rows wider than 256 columns), so small planes put several rows in
// one warp; the host picks the segment length so that every shape fills the
// card, and picks the aligned (vector) path only when every row starts on a
// 16-byte boundary (W % 8 == 0), else the scalar path.
//
// up2x: one block of 256 threads per (group of planes, output tile). The
// block loads its input tile with the halo into shared memory as f32, runs
// the row pass into a shared intermediate, then the column pass, and writes
// each output once. Tiles are at most 32 x 32 outputs; when a plane is
// smaller, one block takes several planes (about 1024 outputs a block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  float k[4];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kThreads = 256;

// ---------------------------------------------------------------- down2x
// columns c0..c0+7 of one input row (zeros outside the row or for a dead lane)
template <typename T, bool VEC>
__device__ __forceinline__ void load8(const T* row, int c0, int W, bool ok, float (&v)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = 0.f;
  if (!ok) return;
  if (VEC) {
    if (c0 < W) {  // W % 8 == 0: all 8 columns or none
      if (sizeof(T) == 2) {
        const uint4 u = *reinterpret_cast<const uint4*>(row + c0);
        const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w4[e]);
          v[2 * e] = __low2float(b);
          v[2 * e + 1] = __high2float(b);
        }
      } else {
        const float4 a = *reinterpret_cast<const float4*>(row + c0);
        const float4 b = *reinterpret_cast<const float4*>(row + c0 + 4);
        v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
        v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c0 + e < W) v[e] = to_f32(row[c0 + e]);
  }
}

// the row pass of one input row at this lane's 4 outputs. Every lane of the
// warp calls it together (it shuffles).
template <typename T, bool VEC>
__device__ __forceinline__ void row_pass(const T* row, int c0, int W, bool ok, bool left_lane,
                                         bool right_lane, float kf0, float kf1, float kf2,
                                         float kf3, float (&h)[4]) {
  float v[8];
  load8<T, VEC>(row, c0, W, ok, v);
  float left = __shfl_up_sync(0xffffffffu, v[7], 1);
  float right = __shfl_down_sync(0xffffffffu, v[0], 1);
  if (!left_lane) left = (ok && c0 > 0) ? to_f32(row[c0 - 1]) : 0.f;
  if (!right_lane) right = (ok && c0 + 8 < W) ? to_f32(row[c0 + 8]) : 0.f;
  // output 4j + t reads columns 8j + 2t - 1 .. 8j + 2t + 2
  h[0] = kf0 * left + kf1 * v[0] + kf2 * v[1] + kf3 * v[2];
  h[1] = kf0 * v[1] + kf1 * v[2] + kf2 * v[3] + kf3 * v[4];
  h[2] = kf0 * v[3] + kf1 * v[4] + kf2 * v[5] + kf3 * v[6];
  h[3] = kf0 * v[5] + kf1 * v[6] + kf2 * v[7] + kf3 * right;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
down2x_kernel(const T* __restrict__ x, T* __restrict__ y, int planes, int H, int W, int OH,
              int OW, int lanes_per_row, int group, int rows, int segs, Taps taps) {
  const float kf0 = taps.k[3], kf1 = taps.k[2], kf2 = taps.k[1], kf3 = taps.k[0];
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int j = (int)(gid % group);
  const long long unit = gid / group;
  const int seg = (int)(unit % segs);
  const long long p = unit / segs;
  const int lane = threadIdx.x & 31;
  const bool live = p < planes && j < lanes_per_row;
  // the neighbouring lane holds the halo column when it is in this group
  // and this warp (groups are warp-aligned)
  const bool left_lane = j > 0 && lane > 0;
  const bool right_lane = j + 1 < group && lane < 31;
  const int c0 = 8 * j;
  const T* xp = x + (live ? p : 0) * (long long)H * W;
  T* yp = y + (live ? p : 0) * (long long)OH * OW;
  const int r0 = seg * rows;

  float hA[4], hB[4], hC[4], hD[4];
  int ir = 2 * r0 - 1;
  row_pass<T, VEC>(xp + (long long)ir * W, c0, W, live && ir >= 0, left_lane, right_lane, kf0,
                   kf1, kf2, kf3, hA);
  ++ir;
  row_pass<T, VEC>(xp + (long long)ir * W, c0, W, live && ir < H, left_lane, right_lane, kf0,
                   kf1, kf2, kf3, hB);
  for (int i = 0; i < rows; ++i) {  // the same trip count for every lane
    const int r = r0 + i;
    ++ir;
    row_pass<T, VEC>(xp + (long long)ir * W, c0, W, live && ir < H, left_lane, right_lane, kf0,
                     kf1, kf2, kf3, hC);
    ++ir;
    row_pass<T, VEC>(xp + (long long)ir * W, c0, W, live && ir < H, left_lane, right_lane, kf0,
                     kf1, kf2, kf3, hD);
    if (live && r < OH) {
      float o[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t] = kf0 * hA[t] + kf1 * hB[t] + kf2 * hC[t] + kf3 * hD[t];
      T* out = yp + (long long)r * OW + 4 * j;
      if (VEC) {  // OW % 4 == 0: the strip is wholly inside the row
        if (sizeof(T) == 2) {
          const __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
          const __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
          uint2 u;
          u.x = *reinterpret_cast<const uint32_t*>(&a);
          u.y = *reinterpret_cast<const uint32_t*>(&b);
          *reinterpret_cast<uint2*>(out) = u;
        } else {
          *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
        }
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (4 * j + t < OW) store(out + t, o[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      hA[t] = hC[t];
      hB[t] = hD[t];
    }
  }
}

template <typename T>
int launch_down(const void* x, void* y, int planes, int H, int W, int vec, int group, int rows,
                Taps taps, cudaStream_t stream) {
  const int OH = H / 2, OW = W / 2;
  const int lanes_per_row = (W + 7) / 8;
  const int segs = (OH + rows - 1) / rows;
  const long long threads = (long long)planes * segs * group;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec) {
    down2x_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), planes, H, W, OH, OW, lanes_per_row, group,
        rows, segs, taps);
  } else {
    down2x_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), planes, H, W, OH, OW, lanes_per_row, group,
        rows, segs, taps);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ up2x
constexpr int kMaxTile = 32;
constexpr int kOutputsPerBlock = 1024;
constexpr size_t kMaxSmem = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
up2x_kernel(const T* __restrict__ x, T* __restrict__ y, int planes, int H, int W, int OH, int OW,
            int toh, int tow, int tiles_y, int tiles_x, int ppb, Taps taps) {
  extern __shared__ float smem[];
  // flipped taps: true convolution
  const float kf0 = taps.k[3], kf1 = taps.k[2], kf2 = taps.k[1], kf3 = taps.k[0];
  const int ith = toh / 2 + 2;  // input tile rows, with halo
  const int itw = tow / 2 + 2;  // input tile cols, with halo

  int b = blockIdx.x;
  const int tx = b % tiles_x;
  b /= tiles_x;
  const int ty = b % tiles_y;
  b /= tiles_y;
  const int plane0 = b * ppb;
  const int np = min(ppb, planes - plane0);
  const int oy0 = ty * toh, ox0 = tx * tow;  // toh, tow are even
  const int iy0 = oy0 / 2 - 1;
  const int ix0 = ox0 / 2 - 1;

  float* s_in = smem;                    // [np][ith][itw]
  float* s_mid = smem + np * ith * itw;  // [np][ith][tow]

  const size_t in_plane = (size_t)H * W;
  const size_t out_plane = (size_t)OH * OW;
  const T* xb = x + (size_t)plane0 * in_plane;
  T* yb = y + (size_t)plane0 * out_plane;

  const int n_in = np * ith * itw;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int c = i % itw;
    const int r = (i / itw) % ith;
    const int p = i / (itw * ith);
    const int gy = iy0 + r, gx = ix0 + c;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f32(xb[p * in_plane + (size_t)gy * W + gx]);
    s_in[i] = v;
  }
  __syncthreads();

  // row pass: every input row of the tile -> tow outputs along W
  const int n_mid = np * ith * tow;
  for (int i = threadIdx.x; i < n_mid; i += kThreads) {
    const int ox = i % tow;
    const float* row = s_in + (i / tow) * itw;
    const int j = ox >> 1;
    s_mid[i] = (ox & 1) ? kf1 * row[j + 1] + kf3 * row[j + 2] : kf0 * row[j] + kf2 * row[j + 1];
  }
  __syncthreads();

  // column pass along H, then one write per output
  const int n_out = np * toh * tow;
  for (int i = threadIdx.x; i < n_out; i += kThreads) {
    const int ox = i % tow;
    const int oy = (i / tow) % toh;
    const int p = i / (tow * toh);
    const int gy = oy0 + oy, gx = ox0 + ox;
    if (gy >= OH || gx >= OW) continue;
    const float* col = s_mid + p * ith * tow + ox;
    const int j = oy >> 1;
    const float v = (oy & 1) ? kf1 * col[(j + 1) * tow] + kf3 * col[(j + 2) * tow]
                             : kf0 * col[j * tow] + kf2 * col[(j + 1) * tow];
    store(yb + p * out_plane + (size_t)gy * OW + gx, v);
  }
}

template <typename T>
int launch_up(const void* x, void* y, int planes, int H, int W, Taps taps, cudaStream_t stream) {
  const int OH = 2 * H;
  const int OW = 2 * W;
  const int toh = OH < kMaxTile ? OH : kMaxTile;
  const int tow = OW < kMaxTile ? OW : kMaxTile;
  const int ith = toh / 2 + 2;
  const int itw = tow / 2 + 2;
  const size_t plane_smem = (size_t)(ith * itw + ith * tow) * sizeof(float);
  int ppb = kOutputsPerBlock / (toh * tow);
  if (ppb < 1) ppb = 1;
  if (ppb > planes) ppb = planes;
  while (ppb > 1 && ppb * plane_smem > kMaxSmem) --ppb;
  const int tiles_y = (OH + toh - 1) / toh;
  const int tiles_x = (OW + tow - 1) / tow;
  const long long blocks = (long long)((planes + ppb - 1) / ppb) * tiles_y * tiles_x;
  up2x_kernel<T><<<(unsigned)blocks, kThreads, ppb * plane_smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), planes, H, W, OH, OW, toh, tow, tiles_y,
      tiles_x, ppb, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// up: 0 = down2x, 1 = up2x. is_bf16: 0 = float, 1 = bfloat16. x and y are
// contiguous (planes, H, W) and (planes, OH, OW) arrays; H and W are even.
// k0..k3 are the taps as given (the kernel flips them). down2x only: `vec`
// (1: W % 8 == 0 and x, y 16-byte aligned), `group` (lanes per row strip)
// and `rows` (output rows per lane) are the launch plan of ops/fir2x.py.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ddgan_fir2x(int up, int is_bf16, const void* x, void* y, int planes, int H, int W,
                           float k0, float k1, float k2, float k3, int vec, int group, int rows,
                           void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || (H & 1) || (W & 1)) return (int)cudaErrorInvalidValue;
  const Taps taps = {{k0, k1, k2, k3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up) {
    return is_bf16 ? launch_up<__nv_bfloat16>(x, y, planes, H, W, taps, s)
                   : launch_up<float>(x, y, planes, H, W, taps, s);
  }
  const int lanes_per_row = (W + 7) / 8;
  if (rows <= 0 || group < lanes_per_row || (group < 32 && (group & (group - 1))) ||
      (group > 32 && group % 32) || (vec && W % 8))
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_down<__nv_bfloat16>(x, y, planes, H, W, vec, group, rows, taps, s)
                 : launch_down<float>(x, y, planes, H, W, vec, group, rows, taps, s);
}
