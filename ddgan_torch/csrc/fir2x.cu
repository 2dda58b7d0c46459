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
// up2x is the same kind of stencil, turned around. Lane j owns input
// columns 4j..4j+3, read with one 8-byte load in bf16 or one 16-byte load
// in f32, and the 8 output columns 8j..8j+7 they feed; the halo columns
// 4j-1 and 4j+4 come from the neighbouring lanes by shuffle (at a warp's
// edge, one narrow load). The lane walks down a segment of input rows m,
// keeps the row pass of rows m-1 and m in registers, and for each new row
// m+1 writes output rows 2m and 2m+1, 8 outputs each, with one 16-byte
// store per row in bf16 or two in f32 (in f32, neighbouring lanes swap
// halves by shuffle first, so each store fills whole 32-byte sectors). The
// next row's load is issued before the current row is computed, so one
// load is always in flight behind the stores. The output holds 4x the
// input's bytes, so the kernel is bound by its stores; it has no shared
// memory, no block barrier and no division per element. Rows -1 and H are
// zeros, and any H, W >= 1 is taken: rows whose input or output does not
// start on 16 bytes (W % 4 != 0, or an offset tensor) take the scalar
// path, chosen on the host with the group and segment sizes
// (`fir2x.up2x_plan`).

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
// One input row's share of a lane: columns c0..c0+3, and the halo columns
// c0-1 and c0+4 where the lane must load them itself (at a warp's edge).
// Zeros outside the row, for a row outside the plane, or for a dead lane.
struct Fetch {
  float v[4];
  float left, right;
};

template <typename T, bool VEC>
__device__ __forceinline__ Fetch fetch4(const T* row, int c0, int W, bool ok, bool left_lane,
                                        bool right_lane) {
  Fetch f;
#pragma unroll
  for (int e = 0; e < 4; ++e) f.v[e] = 0.f;
  f.left = f.right = 0.f;
  if (!ok) return f;
  if (VEC) {
    if (c0 < W) {  // W % 4 == 0: all 4 columns or none
      if (sizeof(T) == 2) {
        const uint2 u = *reinterpret_cast<const uint2*>(row + c0);
        const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
        const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
        f.v[0] = __low2float(a), f.v[1] = __high2float(a);
        f.v[2] = __low2float(b), f.v[3] = __high2float(b);
      } else {
        const float4 a = *reinterpret_cast<const float4*>(row + c0);
        f.v[0] = a.x, f.v[1] = a.y, f.v[2] = a.z, f.v[3] = a.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < W) f.v[e] = to_f32(row[c0 + e]);
  }
  if (!left_lane && c0 > 0) f.left = to_f32(row[c0 - 1]);
  if (!right_lane && c0 + 4 < W) f.right = to_f32(row[c0 + 4]);
  return f;
}

// the row pass of one fetched input row at this lane's 8 output columns.
// Every lane of the warp calls it together (it shuffles).
__device__ __forceinline__ void up_row_pass(const Fetch& f, bool left_lane, bool right_lane,
                                            float kf0, float kf1, float kf2, float kf3,
                                            float (&h)[8]) {
  float left = __shfl_up_sync(0xffffffffu, f.v[3], 1);
  float right = __shfl_down_sync(0xffffffffu, f.v[0], 1);
  if (!left_lane) left = f.left;
  if (!right_lane) right = f.right;
  // out[2m] = kf0 x[m-1] + kf2 x[m], out[2m+1] = kf1 x[m] + kf3 x[m+1]
  h[0] = kf0 * left + kf2 * f.v[0];
  h[1] = kf1 * f.v[0] + kf3 * f.v[1];
  h[2] = kf0 * f.v[0] + kf2 * f.v[1];
  h[3] = kf1 * f.v[1] + kf3 * f.v[2];
  h[4] = kf0 * f.v[1] + kf2 * f.v[2];
  h[5] = kf1 * f.v[2] + kf3 * f.v[3];
  h[6] = kf0 * f.v[2] + kf2 * f.v[3];
  h[7] = kf1 * f.v[3] + kf3 * right;
}

// output columns c..c+7 of one output row
template <typename T, bool VEC>
__device__ __forceinline__ void store8(T* out, int c, int OW, const float (&o)[8]) {
  if (VEC) {  // OW % 8 == 0: the strip is wholly inside the row
    if (sizeof(T) == 2) {
      uint32_t w4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
        w4[e] = *reinterpret_cast<const uint32_t*>(&b);
      }
      *reinterpret_cast<uint4*>(out) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
    } else {
      *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<float4*>(out + 4) = make_float4(o[4], o[5], o[6], o[7]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c + e < OW) store(out + e, o[e]);
  }
}

// f32 output columns on the vector path, for groups of two lanes or more:
// lanes 2i and 2i+1 swap halves so that each of the pair's two 16-byte
// stores fills one whole 32-byte sector (lane 2i writes columns 16i..16i+3
// and 16i+8..16i+11, lane 2i+1 columns 16i+4..16i+7 and 16i+12..16i+15).
// Every lane of the warp calls it together (it shuffles); a lane past the
// row's end still stores its partner's half.
__device__ __forceinline__ void store8_pairs(float* row, int j, int OW, bool ok,
                                             const float (&o)[8]) {
  const bool odd = j & 1;
  float s[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) s[t] = __shfl_xor_sync(0xffffffffu, odd ? o[t] : o[4 + t], 1);
  if (!ok) return;
  const int c = 16 * (j >> 1) + 4 * odd;
  const float4 a = odd ? make_float4(s[0], s[1], s[2], s[3]) : make_float4(o[0], o[1], o[2], o[3]);
  const float4 b = odd ? make_float4(o[4], o[5], o[6], o[7]) : make_float4(s[0], s[1], s[2], s[3]);
  if (c < OW) *reinterpret_cast<float4*>(row + c) = a;  // OW % 8 == 0
  if (c + 8 < OW) *reinterpret_cast<float4*>(row + c + 8) = b;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
up2x_kernel(const T* __restrict__ x, T* __restrict__ y, int planes, int H, int W, int OW,
            int lanes_per_row, int group, int rows, int segs, Taps taps) {
  // flipped taps: true convolution
  const float kf0 = taps.k[3], kf1 = taps.k[2], kf2 = taps.k[1], kf3 = taps.k[0];
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int j = (int)(gid % group);
  const long long unit = gid / group;
  const int seg = (int)(unit % segs);
  const long long p = unit / segs;
  const int lane = threadIdx.x & 31;
  const bool in_plane = p < planes;
  const bool live = in_plane && j < lanes_per_row;
  // the neighbouring lane holds the halo column when it is in this group
  // and this warp (groups are warp-aligned)
  const bool left_lane = j > 0 && lane > 0;
  const bool right_lane = j + 1 < group && lane < 31;
  const bool pairs = VEC && sizeof(T) == 4 && group > 1;
  const int c0 = 4 * j;
  const T* xp = x + (live ? p : 0) * (long long)H * W;
  T* yp = y + (in_plane ? p : 0) * (long long)(2 * H) * OW;
  const int r0 = seg * rows;

  float hA[8], hB[8], hC[8];
  Fetch f = fetch4<T, VEC>(xp + (long long)(r0 - 1) * W, c0, W, live && r0 > 0, left_lane,
                           right_lane);
  up_row_pass(f, left_lane, right_lane, kf0, kf1, kf2, kf3, hA);
  f = fetch4<T, VEC>(xp + (long long)r0 * W, c0, W, live && r0 < H, left_lane, right_lane);
  Fetch next = fetch4<T, VEC>(xp + (long long)(r0 + 1) * W, c0, W, live && r0 + 1 < H,
                              left_lane, right_lane);
  up_row_pass(f, left_lane, right_lane, kf0, kf1, kf2, kf3, hB);
  for (int i = 0; i < rows; ++i) {  // the same trip count for every lane
    const int m = r0 + i;
    f = next;
    // row m+2 is loaded while row m+1 is computed and stored
    next = fetch4<T, VEC>(xp + (long long)(m + 2) * W, c0, W, live && i + 1 < rows && m + 2 < H,
                          left_lane, right_lane);
    up_row_pass(f, left_lane, right_lane, kf0, kf1, kf2, kf3, hC);
    T* out = yp + (long long)(2 * m) * OW;
    float o[8], o1[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      o[t] = kf0 * hA[t] + kf2 * hB[t];
      o1[t] = kf1 * hB[t] + kf3 * hC[t];
    }
    if (pairs) {  // the same for every lane of the warp
      store8_pairs(reinterpret_cast<float*>(out), j, OW, in_plane && m < H, o);
      store8_pairs(reinterpret_cast<float*>(out + OW), j, OW, in_plane && m < H, o1);
    } else if (live && m < H) {
      store8<T, VEC>(out + 8 * j, 8 * j, OW, o);
      store8<T, VEC>(out + OW + 8 * j, 8 * j, OW, o1);
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      hA[t] = hB[t];
      hB[t] = hC[t];
    }
  }
}

template <typename T>
int launch_up(const void* x, void* y, int planes, int H, int W, int vec, int group, int rows,
              Taps taps, cudaStream_t stream) {
  const int OW = 2 * W;
  const int lanes_per_row = (W + 3) / 4;
  const int segs = (H + rows - 1) / rows;
  const long long threads = (long long)planes * segs * group;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (vec) {
    up2x_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), planes, H, W, OW, lanes_per_row, group, rows,
        segs, taps);
  } else {
    up2x_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), planes, H, W, OW, lanes_per_row, group, rows,
        segs, taps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// up: 0 = down2x, 1 = up2x. is_bf16: 0 = float, 1 = bfloat16. x and y are
// contiguous (planes, H, W) and (planes, OH, OW) arrays; for down2x H and W
// are even, for up2x any size >= 1. k0..k3 are the taps as given (the
// kernel flips them). `vec` (1: the rows start on 16 bytes, W % 8 == 0 for
// down2x, W % 4 == 0 for up2x, and x, y 16-byte aligned), `group` (lanes
// per row strip) and `rows` (rows per lane: output rows for down2x, input
// rows for up2x) are the launch plan of ops/fir2x.py (`down2x_plan`,
// `up2x_plan`). Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int ddgan_fir2x(int up, int is_bf16, const void* x, void* y, int planes, int H, int W,
                           float k0, float k1, float k2, float k3, int vec, int group, int rows,
                           void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || (!up && ((H & 1) || (W & 1))))
    return (int)cudaErrorInvalidValue;
  const int lanes_per_row = up ? (W + 3) / 4 : (W + 7) / 8;
  if (rows <= 0 || group < lanes_per_row || (group < 32 && (group & (group - 1))) ||
      (group > 32 && group % 32) || (vec && W % (up ? 4 : 8)))
    return (int)cudaErrorInvalidValue;
  const Taps taps = {{k0, k1, k2, k3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up) {
    return is_bf16 ? launch_up<__nv_bfloat16>(x, y, planes, H, W, vec, group, rows, taps, s)
                   : launch_up<float>(x, y, planes, H, W, vec, group, rows, taps, s);
  }
  return is_bf16 ? launch_down<__nv_bfloat16>(x, y, planes, H, W, vec, group, rows, taps, s)
                 : launch_down<float>(x, y, planes, H, W, vec, group, rows, taps, s);
}
