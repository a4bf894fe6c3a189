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
// (K+1)^2 window of the volume and writes K^2 fp32 outputs, doing ~9 flops
// per output, far below the H100's ~20 flops/byte balance point. At the
// Sintel demo geometry (55x128 grid, r=4, fp32) that is ~20 MB, ~6 us at
// 3.35 TB/s.
//
// Design (the simple one that is right first):
// - One warp per (query, level) item, items walked grid-stride. The warp
//   stages the (K+1)^2 integer window in shared memory (one read of each
//   window value instead of the four a 4-corner gather makes), then applies
//   the separable 2-tap lerp, y first then x, in fp32 -- the order of
//   models/corr.py::_separable_lerp in the JAX package.
// - The volume is read unpadded. The TPU kernel's 2r+3 zero margin, the
//   rounding of N up to _QMAX, the iota mask-select and the (1,Q,1,1)
//   scalar blocks existed only for the TPU's tiling and VMEM; here each tap
//   masks its out-of-range corner to zero instead. An empty level (Hl or
//   Wl 0, pooled from a grid under 8 px a side) masks every tap and is
//   never read, so it gives zeros, as in the JAX package.
// - Coords are clamped to [-(r+2), S+r+1] before floor, as _prep_coords
//   does; that leaves the result unchanged and keeps the int conversion
//   defined.
// - All levels go in one launch: their pointers and sizes ride in a small
//   struct passed as a __grid_constant__ kernel parameter (indexed by level
//   without a local copy).
// - The volume may be fp32 or bf16; the lerp is fp32 either way.
// Items are ordered query-major, so the warps of one block write one
// query's L*K^2 contiguous output channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define RAFT_MAX_LEVELS 8

struct Levels {
  const void* vol[RAFT_MAX_LEVELS];
  int h[RAFT_MAX_LEVELS];
  int w[RAFT_MAX_LEVELS];
};

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void corr_lookup_kernel(const __grid_constant__ Levels lv,
                                   int levels,
                                   const float* __restrict__ coords,
                                   float* __restrict__ out,
                                   long long queries, int radius) {
  extern __shared__ float smem[];
  const int K = 2 * radius + 1;
  const int P = K + 1;
  const int KK = K * K;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* win = smem + warp * P * P;
  const long long items = queries * levels;
  const long long channels = (long long)levels * KK;

  for (long long item = (long long)blockIdx.x * warps + warp; item < items;
       item += (long long)gridDim.x * warps) {
    const long long q = item / levels;
    const int l = (int)(item - q * levels);
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

    const T* v = static_cast<const T*>(lv.vol[l]) + q * (long long)H * W;
    for (int i = lane; i < P * P; i += 32) {
      const int iy = y0 + i / P;
      const int ix = x0 + i % P;
      float val = 0.0f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        val = load_as_float(v + (long long)iy * W + ix);
      }
      win[i] = val;  // win is [y][x], P x P
    }
    __syncwarp();

    float* o = out + q * channels + (long long)l * KK;
    for (int t = lane; t < KK; t += 32) {
      const int xi = t / K;  // x-major: the x offset is the outer index
      const int yi = t - xi * K;
      const float* r0 = win + yi * P + xi;
      const float a = (1.0f - wy) * r0[0] + wy * r0[P];
      const float b = (1.0f - wy) * r0[1] + wy * r0[P + 1];
      o[t] = (1.0f - wx) * a + wx * b;
    }
    __syncwarp();  // the window is rewritten by the next item
  }
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
  const int threads = 256;
  const int warps = threads / 32;
  const int P = 2 * radius + 2;
  const size_t smem = (size_t)warps * P * P * sizeof(float);
  long long blocks = (queries * levels + warps - 1) / warps;
  if (blocks == 0) return 0;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;  // grid-stride covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    corr_lookup_kernel<float><<<(unsigned)blocks, threads, smem, s>>>(
        lv, levels, c, o, queries, radius);
  } else if (dtype == 1) {
    corr_lookup_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, smem, s>>>(
        lv, levels, c, o, queries, radius);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
