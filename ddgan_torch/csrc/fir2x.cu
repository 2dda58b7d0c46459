// Separable 4-tap FIR resampling by 2 for Hopper (sm_90a): the down2x and
// up2x patterns of upfirdn2d, on NCHW planes of float or bfloat16.
//
// Replaces the Pallas TPU kernel `_sep_mxu_kernel`
// (ddgan_tpu/ops/experimental/pallas_upfirdn.py:56, launched by
// `_sep_mxu_pallas` :75 for `down2x` :133 and `up2x` :158). That kernel
// computed out = Mh . X . Mw^T with banded matrices so the TPU's matrix
// unit could do the work; Mh and Mw are mostly zeros, and here the op is
// bound by memory (a few flops per byte), so this kernel computes the
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
//
// Design: one block of 256 threads per (group of planes, output tile).
// The block loads its input tile with the halo into shared memory as f32
// (one read of each input byte from device memory, coalesced along rows),
// runs the row pass into a shared intermediate, then the column pass, and
// writes each output once. Tiles are at most 32 x 32 outputs; when a plane
// is smaller, one block takes several planes (about 1024 outputs a block)
// so that small planes still give each thread a few outputs. Accumulation
// is in f32 for both types.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Taps {
  float k[4];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kThreads = 256;
constexpr int kMaxTile = 32;
constexpr int kOutputsPerBlock = 1024;
constexpr size_t kMaxSmem = 48 * 1024;

template <typename T, bool UP>
__global__ void __launch_bounds__(kThreads)
fir2x_kernel(const T* __restrict__ x, T* __restrict__ y, int planes, int H, int W,
             int OH, int OW, int toh, int tow, int tiles_y, int tiles_x, int ppb,
             Taps taps) {
  extern __shared__ float smem[];
  // flipped taps: true convolution
  const float kf0 = taps.k[3], kf1 = taps.k[2], kf2 = taps.k[1], kf3 = taps.k[0];
  const int ith = UP ? toh / 2 + 2 : 2 * toh + 2;  // input tile rows, with halo
  const int itw = UP ? tow / 2 + 2 : 2 * tow + 2;  // input tile cols, with halo

  int b = blockIdx.x;
  const int tx = b % tiles_x;
  b /= tiles_x;
  const int ty = b % tiles_y;
  b /= tiles_y;
  const int plane0 = b * ppb;
  const int np = min(ppb, planes - plane0);
  const int oy0 = ty * toh, ox0 = tx * tow;  // toh, tow are even for UP
  const int iy0 = UP ? oy0 / 2 - 1 : 2 * oy0 - 1;
  const int ix0 = UP ? ox0 / 2 - 1 : 2 * ox0 - 1;

  float* s_in = smem;                      // [np][ith][itw]
  float* s_mid = smem + np * ith * itw;    // [np][ith][tow]

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
    float v;
    if (UP) {
      const int j = ox >> 1;
      v = (ox & 1) ? kf1 * row[j + 1] + kf3 * row[j + 2] : kf0 * row[j] + kf2 * row[j + 1];
    } else {
      const int j = 2 * ox;
      v = kf0 * row[j] + kf1 * row[j + 1] + kf2 * row[j + 2] + kf3 * row[j + 3];
    }
    s_mid[i] = v;
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
    float v;
    if (UP) {
      const int j = oy >> 1;
      v = (oy & 1) ? kf1 * col[(j + 1) * tow] + kf3 * col[(j + 2) * tow]
                   : kf0 * col[j * tow] + kf2 * col[(j + 1) * tow];
    } else {
      const int j = 2 * oy;
      v = kf0 * col[j * tow] + kf1 * col[(j + 1) * tow] + kf2 * col[(j + 2) * tow] +
          kf3 * col[(j + 3) * tow];
    }
    store(yb + p * out_plane + (size_t)gy * OW + gx, v);
  }
}

template <typename T, bool UP>
int launch(const void* x, void* y, int planes, int H, int W, Taps taps, cudaStream_t stream) {
  const int OH = UP ? 2 * H : H / 2;
  const int OW = UP ? 2 * W : W / 2;
  const int toh = OH < kMaxTile ? OH : kMaxTile;
  const int tow = OW < kMaxTile ? OW : kMaxTile;
  const int ith = UP ? toh / 2 + 2 : 2 * toh + 2;
  const int itw = UP ? tow / 2 + 2 : 2 * tow + 2;
  const size_t plane_smem = (size_t)(ith * itw + ith * tow) * sizeof(float);
  int ppb = kOutputsPerBlock / (toh * tow);
  if (ppb < 1) ppb = 1;
  if (ppb > planes) ppb = planes;
  while (ppb > 1 && ppb * plane_smem > kMaxSmem) --ppb;
  const int tiles_y = (OH + toh - 1) / toh;
  const int tiles_x = (OW + tow - 1) / tow;
  const long long blocks = (long long)((planes + ppb - 1) / ppb) * tiles_y * tiles_x;
  fir2x_kernel<T, UP><<<(unsigned)blocks, kThreads, ppb * plane_smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), planes, H, W, OH, OW, toh, tow, tiles_y,
      tiles_x, ppb, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// up: 0 = down2x, 1 = up2x. is_bf16: 0 = float, 1 = bfloat16. x and y are
// contiguous (planes, H, W) and (planes, OH, OW) arrays; H and W are even.
// k0..k3 are the taps as given (the kernel flips them). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ddgan_fir2x(int up, int is_bf16, const void* x, void* y, int planes, int H, int W,
                           float k0, float k1, float k2, float k3, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || (H & 1) || (W & 1)) return (int)cudaErrorInvalidValue;
  const Taps taps = {{k0, k1, k2, k3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (up) {
    return is_bf16 ? launch<__nv_bfloat16, true>(x, y, planes, H, W, taps, s)
                   : launch<float, true>(x, y, planes, H, W, taps, s);
  }
  return is_bf16 ? launch<__nv_bfloat16, false>(x, y, planes, H, W, taps, s)
                 : launch<float, false>(x, y, planes, H, W, taps, s);
}
