// Correlation window lookup, and its adjoint (corr_scatter, below), for
// Hopper (sm_90a).
//
// Replaces raft_tpu/kernels/corr_pallas.py::_lookup_kernel (reached through
// _level_lookup_pallas and corr_lookup_pallas). For every query pixel q and
// every pyramid level l it bilinearly samples the (2r+1)^2 window around
// coords[q] / 2^l from the query's own (Hl, Wl) slice of the correlation
// volume, with grid_sample's zeros semantics, and writes fp32 channels in
// the x-major order c = l*K^2 + x_idx*K + y_idx (K = 2r+1).
//
// What bounds it on this card: bytes. Each (query, level) reads at most a
// (K+1)^2 window of its own slice -- values no other query reads -- and
// writes K^2 fp32 outputs, ~9 flops per output, far below the H100's ~20
// flops/byte balance point: 58.7 MB at the chairs training geometry (B=10,
// 46x62 grid, r=4, fp32), 17.5 us at 3.35 TB/s. The window rows are 10
// values at arbitrary offsets, so the DRAM moves whole 32-byte sectors:
// more than the bound's bytes, a cost of access granularity no design
// removes. The first design (a warp per (query, level)) ran at ~5.5x the
// bound: two dependent round trips per item (coords, then window), at most
// four loads in flight per lane, and a per-item overhead paid even by the
// mostly out-of-range windows of the coarse levels.
//
// Design:
// - One warp per query, covering every level. The coords are read once
//   (and the next query's are prefetched while this one's window is
//   lerped). The lanes split into one group per level (8 lanes each at 4
//   levels) and each group issues its level's in-range window loads, eight
//   per lane per round, before it stores any: at r=4 and 4 levels a lane
//   has ~13 independent loads, two rounds, instead of <=4 behind the
//   coords. Out-of-range taps are masked to zero and never read.
// - The (K+1)^2 windows of all levels, and each level's fractions, go to
//   the warp's shared memory; the separable 2-tap lerp, y first then x, in
//   fp32 -- the order of models/corr.py::_separable_lerp in the JAX
//   package -- then writes the query's L*K^2 contiguous output channels as
//   one coalesced run.
// - Persistent blocks: as many as fit on the card at once, each warp
//   walking queries grid-stride.
// - The volume is read unpadded. The TPU kernel's 2r+3 zero margin, the
//   rounding of N up to _QMAX, the iota mask-select and the (1,Q,1,1)
//   scalar blocks existed only for the TPU's tiling and VMEM. An empty
//   level (Hl or Wl 0, pooled from a grid under 8 px a side) masks every
//   tap and is never read, so it gives zeros, as in the JAX package.
// - Coords are clamped to [-(r+2), S+r+1] before floor, as _prep_coords
//   does; that leaves the result unchanged and keeps the int conversion
//   defined.
// - All levels go in one launch: their pointers and sizes ride in a small
//   struct passed as a __grid_constant__ kernel parameter.
// - The volume may be fp32 or bf16; the lerp is fp32 either way. Each
//   output is computed from the same values in the same order whatever the
//   launch shape, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RAFT_MAX_LEVELS 8

struct Levels {
  const void* vol[RAFT_MAX_LEVELS];
  int h[RAFT_MAX_LEVELS];
  int w[RAFT_MAX_LEVELS];
};

__device__ __forceinline__ float load_as_float(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// floor(i / d) for 0 <= i < 2^20 through one float multiply: (i + 0.5) / d
// lies at least 0.5 / d away from an integer, and the multiply by the
// rounded 1/d is off by under (i + 0.5) / d * 2^-22, which is less.
__device__ __forceinline__ int div_small(int i, float inv_d) {
  return (int)(((float)i + 0.5f) * inv_d);
}

constexpr int LOOKUP_UNROLL = 8;  // window loads in flight per lane per round

template <typename T>
__global__ void corr_lookup_kernel(const __grid_constant__ Levels lv,
                                   int levels, int group_shift,
                                   const float* __restrict__ coords,
                                   float* __restrict__ out,
                                   long long queries, int radius) {
  extern __shared__ float smem[];
  const int K = 2 * radius + 1;
  const int P = K + 1;
  const int KK = K * K;
  const int PP = P * P;
  const float inv_p = 1.0f / (float)P;
  const float inv_k = 1.0f / (float)K;
  const float inv_kk = 1.0f / (float)KK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* win = smem + (long long)warp * (levels * PP + 2 * RAFT_MAX_LEVELS);
  float* frac = win + levels * PP;  // [level][x, y] bilinear fractions
  const int group = 1 << group_shift;  // lanes per level
  const int my_level = lane >> group_shift;
  const int sub = lane & (group - 1);
  const int channels = levels * KK;
  const long long stride = (long long)gridDim.x * warps;

  long long q = (long long)blockIdx.x * warps + warp;
  float cx = 0.0f, cy = 0.0f;
  if (q < queries) {
    cx = coords[2 * q];
    cy = coords[2 * q + 1];
  }
  for (; q < queries; q += stride) {
    const long long qn = q + stride;  // prefetch the next query's coords
    float nx = 0.0f, ny = 0.0f;
    if (qn < queries) {
      nx = coords[2 * qn];
      ny = coords[2 * qn + 1];
    }
    if (my_level < levels) {
      const int l = my_level;
      const int H = lv.h[l];
      const int W = lv.w[l];
      const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
      float x = cx * scale;
      float y = cy * scale;
      x = fminf(fmaxf(x, -(radius + 2.0f)), (float)W + radius + 1.0f);
      y = fminf(fmaxf(y, -(radius + 2.0f)), (float)H + radius + 1.0f);
      const float xf = floorf(x);
      const float yf = floorf(y);
      const int x0 = (int)xf - radius;
      const int y0 = (int)yf - radius;
      if (sub == 0) {
        frac[2 * l] = x - xf;
        frac[2 * l + 1] = y - yf;
      }
      const T* v = static_cast<const T*>(lv.vol[l]) + q * (long long)H * W;
      float* wl = win + l * PP;
      for (int i0 = sub; i0 < PP; i0 += group * LOOKUP_UNROLL) {
        float val[LOOKUP_UNROLL];
#pragma unroll
        for (int u = 0; u < LOOKUP_UNROLL; ++u) {
          const int i = i0 + u * group;
          const int py = div_small(i, inv_p);
          const int iy = y0 + py;
          const int ix = x0 + i - py * P;
          val[u] = 0.0f;
          if (i < PP && iy >= 0 && iy < H && ix >= 0 && ix < W) {
            val[u] = load_as_float(v + (long long)iy * W + ix);
          }
        }
#pragma unroll
        for (int u = 0; u < LOOKUP_UNROLL; ++u) {
          const int i = i0 + u * group;
          if (i < PP) wl[i] = val[u];
        }
      }
    }
    __syncwarp();

    float* o = out + q * channels;
    for (int t = lane; t < channels; t += 32) {
      const int l = div_small(t, inv_kk);
      const int tap = t - l * KK;
      const int xi = div_small(tap, inv_k);  // x-major: x is the outer index
      const int yi = tap - xi * K;
      const float wx = frac[2 * l];
      const float wy = frac[2 * l + 1];
      const float* r0 = win + l * PP + yi * P + xi;
      const float a = (1.0f - wy) * r0[0] + wy * r0[P];
      const float b = (1.0f - wy) * r0[1] + wy * r0[P + 1];
      o[t] = (1.0f - wx) * a + wx * b;
    }
    __syncwarp();  // the windows are rewritten for the next query
    cx = nx;
    cy = ny;
  }
}

template <typename T>
static int lookup_launch(const Levels& lv, int levels, const float* coords,
                         float* out, long long queries, int radius,
                         cudaStream_t s) {
  const int P = 2 * radius + 2;
  const long long warp_bytes =
      ((long long)levels * P * P + 2 * RAFT_MAX_LEVELS) * sizeof(float);
  int dev = 0, optin = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int warps = 8;
  while (warps > 1 && warps * warp_bytes > optin) --warps;
  const long long smem = warps * warp_bytes;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      corr_lookup_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, corr_lookup_kernel<T>, warps * 32, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (queries + warps - 1) / warps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;  // grid-stride covers the rest
  int lp = 1;  // lanes split into a power-of-two number of level groups
  while (lp < levels) lp <<= 1;
  int shift = 0;
  while ((32 >> shift) > lp) ++shift;  // 32 / lp == 1 << shift
  corr_lookup_kernel<T><<<(unsigned)blocks, warps * 32, smem, s>>>(
      lv, levels, shift, coords, out, queries, radius);
  return (int)cudaGetLastError();
}

extern "C" int corr_lookup_launch(const void* const* vols, const int* hs,
                                  const int* ws, int levels,
                                  const void* coords, void* out,
                                  long long queries, int radius, int dtype,
                                  void* stream) {
  if (levels < 1 || levels > RAFT_MAX_LEVELS || radius < 1 || queries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  for (int l = 0; l < RAFT_MAX_LEVELS; ++l) {
    lv.vol[l] = l < levels ? vols[l] : nullptr;
    lv.h[l] = l < levels ? hs[l] : 0;
    lv.w[l] = l < levels ? ws[l] : 0;
  }
  if (queries == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return lookup_launch<float>(lv, levels, c, o, queries,
                                              radius, s);
  if (dtype == 1) return lookup_launch<__nv_bfloat16>(lv, levels, c, o,
                                                      queries, radius, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// corr_scatter: the adjoint of corr_lookup, for training.
//
// Replaces raft_tpu/kernels/corr_pallas.py::_scatter_kernel (reached through
// _level_scatter_pallas and _lookup_bwd). For every (query, level) it takes
// the K^2 window cotangents g (fp32, x-major channels, as corr_lookup writes
// them), runs the adjoint of the separable lerp -- x first, then y, the
// reverse of the forward -- into a (K+1)^2 fp32 window, and stores the
// in-range taps into the query's own (Hl, Wl) slice of the gradient volume.
// The caller zero-fills the volume; out-of-range taps are dropped (in JAX
// they land in the zero margin that the pad's VJP slices off).
//
// What bounds it on this card: bytes. The zero fill writes the whole
// gradient volume (429.5 MB in fp32 at the chairs training geometry, B=10,
// 46x62 grid), the kernel reads 4*K^2 bytes of cotangent per (query, level)
// and writes at most (K+1)^2 values into it; ~0.14 ms at 3.35 TB/s.
//
// Design: the structure of corr_lookup, not the TPU kernel's (its 2r+3
// margin, N rounded up to _QMAX, iota mask-adds over whole (Q,Hp,Wp) blocks
// and a full-slice write per query exist for VMEM tiling):
// - one warp per (query, level) item, walked grid-stride, all levels in one
//   launch, coords clamped as corr_lookup clamps them;
// - the warp stages its K^2 cotangents in shared memory, then each lane
//   forms (K+1)^2 window entries, dwl = (1-wx)*g[x] + wx*g[x-1] along x and
//   dwin = (1-wy)*dwl[y] + wy*dwl[y-1] along y, in fp32;
// - each query owns its slice, so there are no atomics, and the result is
//   bitwise the same from run to run;
// - stores are in the volume's dtype (fp32 or bf16), one rounding from fp32.

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct LevelsOut {
  void* vol[RAFT_MAX_LEVELS];
  int h[RAFT_MAX_LEVELS];
  int w[RAFT_MAX_LEVELS];
};

template <typename T>
__global__ void corr_scatter_kernel(const __grid_constant__ LevelsOut lv,
                                    int levels,
                                    const float* __restrict__ coords,
                                    const float* __restrict__ grad,
                                    long long queries, int radius) {
  extern __shared__ float smem[];
  const int K = 2 * radius + 1;
  const int P = K + 1;
  const int KK = K * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* g = smem + warp * KK;  // [x][y], x-major as the channels
  const long long items = queries * levels;
  const long long channels = (long long)levels * KK;

  for (long long item = (long long)blockIdx.x * warps + warp; item < items;
       item += (long long)gridDim.x * warps) {
    const long long q = item / levels;
    const int l = (int)(item - q * levels);
    const int H = lv.h[l];
    const int W = lv.w[l];
    if (H == 0 || W == 0) continue;  // an empty level has nothing to store
    const float scale = 1.0f / (float)(1 << l);
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

    const float* gq = grad + q * channels + (long long)l * KK;
    for (int t = lane; t < KK; t += 32) g[t] = gq[t];
    __syncwarp();

    T* v = static_cast<T*>(lv.vol[l]) + q * (long long)H * W;
    for (int i = lane; i < P * P; i += 32) {
      const int py = i / P;
      const int px = i - py * P;
      const int iy = y0 + py;
      const int ix = x0 + px;
      if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
      // dwl(yy, px): the x adjoint of window row yy at column px
      float d = 0.0f;
      if (py < K) {
        float dwl = 0.0f;
        if (px < K) dwl = (1.0f - wx) * g[px * K + py];
        if (px >= 1) dwl = dwl + wx * g[(px - 1) * K + py];
        d = (1.0f - wy) * dwl;
      }
      if (py >= 1) {
        float dwl = 0.0f;
        if (px < K) dwl = (1.0f - wx) * g[px * K + py - 1];
        if (px >= 1) dwl = dwl + wx * g[(px - 1) * K + py - 1];
        d = d + wy * dwl;
      }
      store_as(v + (long long)iy * W + ix, d);
    }
    __syncwarp();  // g is rewritten by the next item
  }
}

extern "C" int corr_scatter_launch(void* const* vols, const int* hs,
                                   const int* ws, int levels,
                                   const void* coords, const void* grad,
                                   long long queries, int radius, int dtype,
                                   void* stream) {
  if (levels < 1 || levels > RAFT_MAX_LEVELS || radius < 1 || queries < 0) {
    return (int)cudaErrorInvalidValue;
  }
  LevelsOut lv;
  for (int l = 0; l < RAFT_MAX_LEVELS; ++l) {
    lv.vol[l] = l < levels ? vols[l] : nullptr;
    lv.h[l] = l < levels ? hs[l] : 0;
    lv.w[l] = l < levels ? ws[l] : 0;
  }
  const int threads = 256;
  const int warps = threads / 32;
  const int K = 2 * radius + 1;
  const size_t smem = (size_t)warps * K * K * sizeof(float);
  long long blocks = (queries * levels + warps - 1) / warps;
  if (blocks == 0) return 0;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  const float* g = static_cast<const float*>(grad);
  if (dtype == 0) {
    corr_scatter_kernel<float><<<(unsigned)blocks, threads, smem, s>>>(
        lv, levels, c, g, queries, radius);
  } else if (dtype == 1) {
    corr_scatter_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, smem, s>>>(
        lv, levels, c, g, queries, radius);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* raft_kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
