// On-the-fly windowed correlation (the alternate_corr path) for Hopper
// (sm_90a).
//
// Replaces raft_tpu/kernels/corr_alt_pallas.py::_alt_kernel (reached through
// _level_alt_pallas and alt_corr_lookup_pallas). For every query pixel q and
// every pyramid level l it dots fmap1's row (C channels) against fmap2[l] at
// each tap of the (2r+2)^2 integer window around coords[q] / 2^l, applies
// the separable 2-tap lerp with the query's fractions (y first, then x, as
// the Pallas kernel does), divides by sqrt(C) and writes fp32 channels in
// the x-major order c = l*K^2 + x_idx*K + y_idx (K = 2r+1). The (H*W)^2
// volume is never built: only fmap1 and the fmap2 pyramid are read.
// Correlation is linear in fmap2, so dotting the integer taps and then
// lerping equals sampling fmap2 bilinearly and then dotting (the plain
// version, models/corr.py::alt_corr_lookup), up to fp32 rounding.
//
// What bounds it on this card: operations. Each (query, level) does
// (2r+2)^2 dots of length C (2*C flops each; 100 taps at r=4) and reads at
// most 100 fmap2 rows, which neighbouring queries share, so the compulsory
// bytes are fmap1, the fmap2 pyramid and the output once: at the KITTI
// geometry (C=256, r=4, N=7,332) 1.50 GFLOP against 26.9 MB, 0.022 ms at
// 67 TFLOP/s against 0.008 ms at 3.35 TB/s.
//
// Design (the simple one that is right first):
// - One warp per (query, level) item, items walked grid-stride, all levels
//   in one launch (the JAX code makes one pallas_call per level). Lanes run
//   across C in 16-byte loads: a tap's fmap2 row (1 KB at C=256) is read
//   coalesced. The fmap1 row sits in registers, V float4 per lane, in
//   chunks of 128*V channels (one chunk at C=128 and C=256).
// - For each tap the bounds test is uniform across the warp: an in-range
//   tap is dotted and reduced with shuffles, an out-of-range one is 0. Lane
//   0 writes the tap into a P x P window in shared memory.
// - fmap2 is read unpadded with bounds checks. The TPU kernel's 2r+3 zero
//   halo, its 8-aligned DMA span (_wspan, _wextra, base stored as x0a/8),
//   the _QTILE padding of N, the DMA ring and the iota column-select existed
//   for Mosaic's tiling and VMEM; none is needed here.
// - Coords are clamped to [-(r+2), S+r+1] before floor, as _prep_coords
//   does, and the fractions come from the clamped value: far-out-of-range
//   queries give exact zeros, and an inf coordinate never reaches an int
//   conversion. An empty level (Hl*Wl = 0) masks every tap, is never read
//   and gives zeros.
// - No atomics: each item owns its K^2 outputs; two calls give the same
//   bits.
//
// Neighbouring queries share 9 of 10 window columns; staging the window of
// a row of queries in shared memory, with the products on tensor cores, is
// the faster design, left for later.

#include <cuda_runtime.h>

#define RAFT_ALT_MAX_LEVELS 8

struct AltLevels {
  const float4* f2[RAFT_ALT_MAX_LEVELS];
  int h[RAFT_ALT_MAX_LEVELS];
  int w[RAFT_ALT_MAX_LEVELS];
};

template <int V>
__global__ void corr_alt_kernel(const __grid_constant__ AltLevels lv,
                                int levels,
                                const float4* __restrict__ fmap1,
                                const float* __restrict__ coords,
                                float* __restrict__ out, long long queries,
                                long long per_batch, int c4, int radius,
                                float sqrt_c) {
  extern __shared__ float smem[];
  const int K = 2 * radius + 1;
  const int P = K + 1;
  const int KK = K * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* win = smem + warp * P * P;  // [y][x], P x P
  const long long items = queries * levels;
  const long long channels = (long long)levels * KK;

  for (long long item = (long long)blockIdx.x * warps + warp; item < items;
       item += (long long)gridDim.x * warps) {
    const long long q = item / levels;
    const int l = (int)(item - q * levels);
    const long long b = q / per_batch;
    const int H = lv.h[l];
    const int W = lv.w[l];
    const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
    float x = coords[2 * q] * scale;
    float y = coords[2 * q + 1] * scale;
    x = fminf(fmaxf(x, -(radius + 2.0f)), (float)W + radius + 1.0f);
    y = fminf(fmaxf(y, -(radius + 2.0f)), (float)H + radius + 1.0f);
    const float xf = floorf(x);
    const float yf = floorf(y);
    const int x0 = (int)xf - radius;
    const int y0 = (int)yf - radius;
    const float wx = x - xf;
    const float wy = y - yf;

    const float4* f1 = fmap1 + q * c4;
    const float4* f2 = lv.f2[l] + b * H * W * c4;
    for (int c0 = 0; c0 < c4; c0 += 32 * V) {
      float4 a[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int k = c0 + v * 32 + lane;
        a[v] = k < c4 ? f1[k] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int t = 0; t < P * P; ++t) {
        const int iy = y0 + t / P;
        const int ix = x0 + t % P;
        float s = 0.0f;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {  // uniform in the warp
          const float4* row = f2 + ((long long)iy * W + ix) * c4;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int k = c0 + v * 32 + lane;
            if (k < c4) {
              const float4 f = row[k];
              s = fmaf(a[v].x, f.x, s);
              s = fmaf(a[v].y, f.y, s);
              s = fmaf(a[v].z, f.z, s);
              s = fmaf(a[v].w, f.w, s);
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            s += __shfl_xor_sync(0xffffffffu, s, o);
          }
        }
        if (lane == 0) win[t] = c0 == 0 ? s : win[t] + s;
      }
    }
    __syncwarp();

    float* o = out + q * channels + (long long)l * KK;
    for (int t = lane; t < KK; t += 32) {
      const int xi = t / K;  // x-major: the x offset is the outer index
      const int yi = t - xi * K;
      const float* r0 = win + yi * P + xi;
      const float lo = (1.0f - wy) * r0[0] + wy * r0[P];
      const float hi = (1.0f - wy) * r0[1] + wy * r0[P + 1];
      o[t] = ((1.0f - wx) * lo + wx * hi) / sqrt_c;
    }
    __syncwarp();  // the window is rewritten by the next item
  }
}

extern "C" int corr_alt_launch(const void* const* f2s, const int* hs,
                               const int* ws, int levels, const void* fmap1,
                               const void* coords, void* out,
                               long long queries, long long per_batch, int c,
                               int radius, float sqrt_c, void* stream) {
  if (levels < 1 || levels > RAFT_ALT_MAX_LEVELS || radius < 1 ||
      queries < 0 || per_batch < 1 || c < 4 || c % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  AltLevels lv;
  for (int l = 0; l < RAFT_ALT_MAX_LEVELS; ++l) {
    lv.f2[l] = l < levels ? static_cast<const float4*>(f2s[l]) : nullptr;
    lv.h[l] = l < levels ? hs[l] : 0;
    lv.w[l] = l < levels ? ws[l] : 0;
  }
  const int threads = 256;
  const int warps = threads / 32;
  const int P = 2 * radius + 2;
  const size_t smem = (size_t)warps * P * P * sizeof(float);
  long long blocks = (queries * levels + warps - 1) / warps;
  if (blocks == 0) return 0;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c4 = c / 4;
  const float4* f1 = static_cast<const float4*>(fmap1);
  const float* xy = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (c4 <= 32) {
    corr_alt_kernel<1><<<(unsigned)blocks, threads, smem, s>>>(
        lv, levels, f1, xy, o, queries, per_batch, c4, radius, sqrt_c);
  } else {
    corr_alt_kernel<2><<<(unsigned)blocks, threads, smem, s>>>(
        lv, levels, f1, xy, o, queries, per_batch, c4, radius, sqrt_c);
  }
  return (int)cudaGetLastError();
}
