// SepConvGRU gate and blend tails, and their backward, for Hopper (sm_90a).
//
// Replaces raft_tpu/kernels/gru_pallas.py::_gates_kernel and ::_blend_kernel
// (reached through gru_gates and gru_blend):
//   gates: (zl, rl, h) -> (z, r*h) with z = sigmoid(zl), r = sigmoid(rl)
//   blend: (z, h, ql)  -> (1 - z)*h + z*tanh(ql)
//
// What bounds them on this card: bytes. Each element is read once per input
// and written once per output with a handful of flops and one or two
// transcendentals in between; at the main path's (1, 7040, 128) fp32
// operands the gates move 5 x 3.6 MB (~5.4 us at 3.35 TB/s) and the blend
// 4 x 3.6 MB (~4.3 us).
//
// Design: one grid-stride elementwise pass per kernel, blockIdx.y walking
// the batch. fp32 or bf16 operands, math in fp32 (expf, tanhf -- no fast
// math, so results sit within about an ulp of the plain PyTorch versions),
// stores in the operands' dtype. The TPU's lane-major (B, H*W, C) layout and
// _row_tile's padding are gone: any layout whose per-batch slice is
// contiguous works, and each operand carries its own batch stride, so the
// z and r halves of the double-width gate conv's NCHW output, (B, 2C, H, W),
// are read in place by offset with no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void gru_gates_kernel(const T* __restrict__ zl,
                                 const T* __restrict__ rl,
                                 const T* __restrict__ h, T* __restrict__ z,
                                 T* __restrict__ rh, long long inner,
                                 long long zl_bs, long long rl_bs,
                                 long long h_bs) {
  const long long b = blockIdx.y;
  const T* zlb = zl + b * zl_bs;
  const T* rlb = rl + b * rl_bs;
  const T* hb = h + b * h_bs;
  T* zb = z + b * inner;
  T* rhb = rh + b * inner;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < inner; i += step) {
    const float zs = 1.0f / (1.0f + expf(-load_f(zlb + i)));
    const float rs = 1.0f / (1.0f + expf(-load_f(rlb + i)));
    store_f(zb + i, zs);
    store_f(rhb + i, rs * load_f(hb + i));
  }
}

template <typename T>
__global__ void gru_blend_kernel(const T* __restrict__ z,
                                 const T* __restrict__ h,
                                 const T* __restrict__ ql, T* __restrict__ out,
                                 long long inner, long long z_bs,
                                 long long h_bs, long long ql_bs) {
  const long long b = blockIdx.y;
  const T* zb = z + b * z_bs;
  const T* hb = h + b * h_bs;
  const T* qb = ql + b * ql_bs;
  T* ob = out + b * inner;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < inner; i += step) {
    const float zv = load_f(zb + i);
    store_f(ob + i, (1.0f - zv) * load_f(hb + i) + zv * tanhf(load_f(qb + i)));
  }
}

// Backward of the two tails, for training. Replaces
// raft_tpu/kernels/gru_pallas.py::_gates_bwd_kernel and ::_blend_bwd_kernel
// (reached through gru_gates' and gru_blend's custom VJPs). As there, z, r
// and tanh(ql) are recomputed from the saved INPUTS rather than saved:
//   gates_bwd: (zl, rl, h, dz, drh) -> dzl = dz*z*(1-z),
//              drl = drh*h*r*(1-r), dh = drh*r
//   blend_bwd: (z, h, ql, g) -> dz = g*(tanh(ql) - h), dh = g*(1-z),
//              dql = g*z*(1 - tanh(ql)^2)
// Bound by bytes like the forward: 5 operands in and 3 out for gates_bwd,
// 4 in and 3 out for blend_bwd (at the chairs training geometry,
// (10, 128, 46, 62) fp32 = 14.6 MB each: 117 MB and 102 MB). Same design as
// the forward: one grid-stride pass, each input with its own batch stride
// (zl and rl are channel-slice views of the double-width gate conv's
// output), fp32 math, outputs contiguous in the operands' dtype.

template <typename T>
__global__ void gru_gates_bwd_kernel(
    const T* __restrict__ zl, const T* __restrict__ rl,
    const T* __restrict__ h, const T* __restrict__ dz,
    const T* __restrict__ drh, T* __restrict__ dzl, T* __restrict__ drl,
    T* __restrict__ dh, long long inner, long long zl_bs, long long rl_bs,
    long long h_bs, long long dz_bs, long long drh_bs) {
  const long long b = blockIdx.y;
  const T* zlb = zl + b * zl_bs;
  const T* rlb = rl + b * rl_bs;
  const T* hb = h + b * h_bs;
  const T* dzb = dz + b * dz_bs;
  const T* drhb = drh + b * drh_bs;
  T* dzlb = dzl + b * inner;
  T* drlb = drl + b * inner;
  T* dhb = dh + b * inner;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < inner; i += step) {
    const float z = 1.0f / (1.0f + expf(-load_f(zlb + i)));
    const float r = 1.0f / (1.0f + expf(-load_f(rlb + i)));
    const float g = load_f(drhb + i);
    store_f(dzlb + i, load_f(dzb + i) * z * (1.0f - z));
    store_f(drlb + i, g * load_f(hb + i) * r * (1.0f - r));
    store_f(dhb + i, g * r);
  }
}

template <typename T>
__global__ void gru_blend_bwd_kernel(
    const T* __restrict__ z, const T* __restrict__ h,
    const T* __restrict__ ql, const T* __restrict__ g, T* __restrict__ dz,
    T* __restrict__ dh, T* __restrict__ dql, long long inner, long long z_bs,
    long long h_bs, long long ql_bs, long long g_bs) {
  const long long b = blockIdx.y;
  const T* zb = z + b * z_bs;
  const T* hb = h + b * h_bs;
  const T* qb = ql + b * ql_bs;
  const T* gb = g + b * g_bs;
  T* dzb = dz + b * inner;
  T* dhb = dh + b * inner;
  T* dqb = dql + b * inner;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < inner; i += step) {
    const float zv = load_f(zb + i);
    const float gv = load_f(gb + i);
    const float t = tanhf(load_f(qb + i));
    store_f(dzb + i, gv * (t - load_f(hb + i)));
    store_f(dhb + i, gv * (1.0f - zv));
    store_f(dqb + i, gv * zv * (1.0f - t * t));
  }
}

static dim3 elementwise_grid(long long inner, int batch, int threads) {
  long long blocks = (inner + threads - 1) / threads;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM; grid-stride beyond
  return dim3((unsigned)blocks, (unsigned)batch);
}

extern "C" int gru_gates_launch(const void* zl, const void* rl, const void* h,
                                void* z, void* rh, long long inner, int batch,
                                long long zl_bs, long long rl_bs,
                                long long h_bs, int dtype, void* stream) {
  if (inner < 0 || batch < 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (inner == 0 || batch == 0) return 0;
  const int threads = 256;
  const dim3 grid = elementwise_grid(inner, batch, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gru_gates_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(zl), static_cast<const float*>(rl),
        static_cast<const float*>(h), static_cast<float*>(z),
        static_cast<float*>(rh), inner, zl_bs, rl_bs, h_bs);
  } else if (dtype == 1) {
    gru_gates_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(zl),
        static_cast<const __nv_bfloat16*>(rl),
        static_cast<const __nv_bfloat16*>(h), static_cast<__nv_bfloat16*>(z),
        static_cast<__nv_bfloat16*>(rh), inner, zl_bs, rl_bs, h_bs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gru_blend_launch(const void* z, const void* h, const void* ql,
                                void* out, long long inner, int batch,
                                long long z_bs, long long h_bs,
                                long long ql_bs, int dtype, void* stream) {
  if (inner < 0 || batch < 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (inner == 0 || batch == 0) return 0;
  const int threads = 256;
  const dim3 grid = elementwise_grid(inner, batch, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gru_blend_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(h),
        static_cast<const float*>(ql), static_cast<float*>(out), inner, z_bs,
        h_bs, ql_bs);
  } else if (dtype == 1) {
    gru_blend_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z),
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(ql),
        static_cast<__nv_bfloat16*>(out), inner, z_bs, h_bs, ql_bs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gru_gates_bwd_launch(const void* zl, const void* rl,
                                    const void* h, const void* dz,
                                    const void* drh, void* dzl, void* drl,
                                    void* dh, long long inner, int batch,
                                    long long zl_bs, long long rl_bs,
                                    long long h_bs, long long dz_bs,
                                    long long drh_bs, int dtype,
                                    void* stream) {
  if (inner < 0 || batch < 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (inner == 0 || batch == 0) return 0;
  const int threads = 256;
  const dim3 grid = elementwise_grid(inner, batch, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gru_gates_bwd_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(zl), static_cast<const float*>(rl),
        static_cast<const float*>(h), static_cast<const float*>(dz),
        static_cast<const float*>(drh), static_cast<float*>(dzl),
        static_cast<float*>(drl), static_cast<float*>(dh), inner, zl_bs,
        rl_bs, h_bs, dz_bs, drh_bs);
  } else if (dtype == 1) {
    gru_gates_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(zl),
        static_cast<const __nv_bfloat16*>(rl),
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(dz),
        static_cast<const __nv_bfloat16*>(drh),
        static_cast<__nv_bfloat16*>(dzl), static_cast<__nv_bfloat16*>(drl),
        static_cast<__nv_bfloat16*>(dh), inner, zl_bs, rl_bs, h_bs, dz_bs,
        drh_bs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gru_blend_bwd_launch(const void* z, const void* h,
                                    const void* ql, const void* g, void* dz,
                                    void* dh, void* dql, long long inner,
                                    int batch, long long z_bs, long long h_bs,
                                    long long ql_bs, long long g_bs,
                                    int dtype, void* stream) {
  if (inner < 0 || batch < 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (inner == 0 || batch == 0) return 0;
  const int threads = 256;
  const dim3 grid = elementwise_grid(inner, batch, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gru_blend_bwd_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const float*>(h),
        static_cast<const float*>(ql), static_cast<const float*>(g),
        static_cast<float*>(dz), static_cast<float*>(dh),
        static_cast<float*>(dql), inner, z_bs, h_bs, ql_bs, g_bs);
  } else if (dtype == 1) {
    gru_blend_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z),
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(ql),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dz), static_cast<__nv_bfloat16*>(dh),
        static_cast<__nv_bfloat16*>(dql), inner, z_bs, h_bs, ql_bs, g_bs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
