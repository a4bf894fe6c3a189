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
// _row_tile's padding are gone. Each batch element of an operand is `outer`
// rows of `inner` contiguous elements, and each input carries its own batch
// and row strides (GruLayout), so views are read in place with no copy:
//   - channels-last (NHWC) operands: a row is one pixel's `inner` = C
//     channels. The z and r halves of the double-width gate conv's
//     channels-last output, (B, 2C, H, W), are rows of C with a row stride
//     of 2C, read coalesced along the channel run; a channel slice of a
//     concatenation's gradient likewise.
//   - operands whose batch slice is contiguous (NCHW, and the halves of an
//     NCHW output): one row of C*H*W elements (`outer` = 1).
// Outputs are dense in the same order: element (b, o, i) at
// (b*outer + o)*inner + i, which the wrapper allocates channels-last or
// contiguous to match. A thread moves 16 bytes of each operand (4 fp32 or 8
// bf16) when every pointer, stride and the row length allow it, else one
// element; the row index costs one 32-bit division per 16 bytes, and none
// when a batch element is one row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

static constexpr int kThreads = 256;
static constexpr int kMaxInputs = 5;

// How a launch addresses its operands (strides in elements).
struct GruLayout {
  long long outer;           // rows per batch element
  long long inner;           // contiguous elements per row
  long long bs[kMaxInputs];  // each input's batch stride
  long long os[kMaxInputs];  // each input's row stride
};

template <int V>
__device__ __forceinline__ void load_v(const float* p, float* f) {
  if constexpr (V == 1) {
    f[0] = *p;
  } else {
    static_assert(V == 4, "16 bytes of fp32");
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
}

template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* f) {
  if constexpr (V == 1) {
    f[0] = __bfloat162float(*p);
  } else {
    static_assert(V == 8, "16 bytes of bf16");
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const float2 t = __bfloat1622float2(b[j]);
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float* f) {
  if constexpr (V == 1) {
    *p = f[0];
  } else {
    static_assert(V == 4, "16 bytes of fp32");
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
}

template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float* f) {
  if constexpr (V == 1) {
    *p = __float2bfloat16(f[0]);
  } else {
    static_assert(V == 8, "16 bytes of bf16");
    uint4 u;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      b[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// Calls f(in, out) for each run of V elements of batch element blockIdx.y:
// in(k) is input k's offset, out the outputs' offset. The launcher keeps a
// batch element's chunk count under 2^32 when it has more than one row.
template <int V, typename F>
__device__ __forceinline__ void for_each_chunk(const GruLayout& L, F f) {
  const long long b = blockIdx.y;
  const long long per_row = L.inner / V;
  const long long total = L.outer * per_row;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < total; c += step) {
    long long o = 0, i = c * V;
    if (L.outer != 1) {
      const unsigned q = (unsigned)c / (unsigned)per_row;
      o = q;
      i = (c - (long long)q * per_row) * V;
    }
    f([&](int k) { return b * L.bs[k] + o * L.os[k] + i; },
      (b * L.outer + o) * L.inner + i);
  }
}

template <typename T, int V>
__global__ void gru_gates_kernel(const T* __restrict__ zl,
                                 const T* __restrict__ rl,
                                 const T* __restrict__ h, T* __restrict__ z,
                                 T* __restrict__ rh, const GruLayout L) {
  for_each_chunk<V>(L, [&](auto in, long long out) {
    float zv[V], rv[V], hv[V];
    load_v<V>(zl + in(0), zv);
    load_v<V>(rl + in(1), rv);
    load_v<V>(h + in(2), hv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      zv[j] = 1.0f / (1.0f + expf(-zv[j]));
      rv[j] = 1.0f / (1.0f + expf(-rv[j])) * hv[j];
    }
    store_v<V>(z + out, zv);
    store_v<V>(rh + out, rv);
  });
}

template <typename T, int V>
__global__ void gru_blend_kernel(const T* __restrict__ z,
                                 const T* __restrict__ h,
                                 const T* __restrict__ ql, T* __restrict__ out,
                                 const GruLayout L) {
  for_each_chunk<V>(L, [&](auto in, long long o) {
    float zv[V], hv[V], qv[V];
    load_v<V>(z + in(0), zv);
    load_v<V>(h + in(1), hv);
    load_v<V>(ql + in(2), qv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      hv[j] = (1.0f - zv[j]) * hv[j] + zv[j] * tanhf(qv[j]);
    }
    store_v<V>(out + o, hv);
  });
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
// the forward: each input with its own batch and row strides (zl and rl the
// halves of the gate conv's output, drh a channel slice of a concatenation's
// gradient), fp32 math, outputs dense in the operands' order and dtype.

template <typename T, int V>
__global__ void gru_gates_bwd_kernel(
    const T* __restrict__ zl, const T* __restrict__ rl,
    const T* __restrict__ h, const T* __restrict__ dz,
    const T* __restrict__ drh, T* __restrict__ dzl, T* __restrict__ drl,
    T* __restrict__ dh, const GruLayout L) {
  for_each_chunk<V>(L, [&](auto in, long long out) {
    float zv[V], rv[V], hv[V], dzv[V], gv[V];
    load_v<V>(zl + in(0), zv);
    load_v<V>(rl + in(1), rv);
    load_v<V>(h + in(2), hv);
    load_v<V>(dz + in(3), dzv);
    load_v<V>(drh + in(4), gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float zs = 1.0f / (1.0f + expf(-zv[j]));
      const float rs = 1.0f / (1.0f + expf(-rv[j]));
      zv[j] = dzv[j] * zs * (1.0f - zs);
      rv[j] = gv[j] * hv[j] * rs * (1.0f - rs);
      hv[j] = gv[j] * rs;
    }
    store_v<V>(dzl + out, zv);
    store_v<V>(drl + out, rv);
    store_v<V>(dh + out, hv);
  });
}

template <typename T, int V>
__global__ void gru_blend_bwd_kernel(
    const T* __restrict__ z, const T* __restrict__ h,
    const T* __restrict__ ql, const T* __restrict__ g, T* __restrict__ dz,
    T* __restrict__ dh, T* __restrict__ dql, const GruLayout L) {
  for_each_chunk<V>(L, [&](auto in, long long out) {
    float zv[V], hv[V], qv[V], gv[V];
    load_v<V>(z + in(0), zv);
    load_v<V>(h + in(1), hv);
    load_v<V>(ql + in(2), qv);
    load_v<V>(g + in(3), gv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float t = tanhf(qv[j]);
      const float zj = zv[j];
      zv[j] = gv[j] * (t - hv[j]);
      hv[j] = gv[j] * (1.0f - zj);
      qv[j] = gv[j] * zj * (1.0f - t * t);
    }
    store_v<V>(dz + out, zv);
    store_v<V>(dh + out, hv);
    store_v<V>(dql + out, qv);
  });
}

// Checks a launch's arguments and fills L from the wrapper's (batch stride,
// row stride) pair for each of the n_in inputs. Sets *v to the elements a
// thread moves at once: 16 bytes' worth when every pointer is 16-byte
// aligned and every stride and the row length are multiples of it, else 1;
// 0 when there is nothing to do.
static int prepare(GruLayout* L, int* v, const long long* strides, int n_in,
                   const void* const* ptrs, int n_ptrs, long long outer,
                   long long inner, int batch, int dtype) {
  if (outer < 0 || inner < 0 || batch < 0 || batch > 65535 ||
      n_in > kMaxInputs || (dtype != 0 && dtype != 1) ||
      (outer > 1 && outer * inner > (long long)UINT_MAX)) {
    return (int)cudaErrorInvalidValue;
  }
  L->outer = outer;
  L->inner = inner;
  const long long width = dtype == 0 ? 4 : 8;
  bool vec = inner % width == 0;
  for (int k = 0; k < n_in; ++k) {
    L->bs[k] = strides[2 * k];
    L->os[k] = strides[2 * k + 1];
    vec = vec && L->bs[k] % width == 0 && L->os[k] % width == 0;
  }
  for (int k = 0; k < n_ptrs; ++k) {
    vec = vec && reinterpret_cast<unsigned long long>(ptrs[k]) % 16 == 0;
  }
  *v = (outer == 0 || inner == 0 || batch == 0) ? 0 : vec ? (int)width : 1;
  return 0;
}

static dim3 chunk_grid(const GruLayout& L, int batch, int v) {
  long long blocks = (L.outer * (L.inner / v) + kThreads - 1) / kThreads;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM; grid-stride beyond
  return dim3((unsigned)blocks, (unsigned)batch);
}

// Each launcher takes the operands, the outputs, each input's (batch
// stride, row stride) pair in `strides`, the rows and row length of a batch
// element, the batch, the dtype (0 fp32, 1 bf16) and the stream.
#define GRU_DISPATCH(KERNEL, ARGS)                               \
  do {                                                           \
    const dim3 grid = chunk_grid(L, batch, v);                   \
    cudaStream_t s = static_cast<cudaStream_t>(stream);          \
    if (dtype == 0) {                                            \
      using T = float;                                           \
      if (v > 1) {                                               \
        KERNEL<T, 4><<<grid, kThreads, 0, s>>> ARGS;             \
      } else {                                                   \
        KERNEL<T, 1><<<grid, kThreads, 0, s>>> ARGS;             \
      }                                                          \
    } else {                                                     \
      using T = __nv_bfloat16;                                   \
      if (v > 1) {                                               \
        KERNEL<T, 8><<<grid, kThreads, 0, s>>> ARGS;             \
      } else {                                                   \
        KERNEL<T, 1><<<grid, kThreads, 0, s>>> ARGS;             \
      }                                                          \
    }                                                            \
  } while (0)

extern "C" int gru_gates_launch(const void* zl, const void* rl, const void* h,
                                void* z, void* rh, const long long* strides,
                                long long outer, long long inner, int batch,
                                int dtype, void* stream) {
  GruLayout L;
  int v = 0;
  const void* ptrs[] = {zl, rl, h, z, rh};
  const int err = prepare(&L, &v, strides, 3, ptrs, 5, outer, inner, batch,
                          dtype);
  if (err != 0 || v == 0) return err;
  GRU_DISPATCH(gru_gates_kernel,
               (static_cast<const T*>(zl), static_cast<const T*>(rl),
                static_cast<const T*>(h), static_cast<T*>(z),
                static_cast<T*>(rh), L));
  return (int)cudaGetLastError();
}

extern "C" int gru_blend_launch(const void* z, const void* h, const void* ql,
                                void* out, const long long* strides,
                                long long outer, long long inner, int batch,
                                int dtype, void* stream) {
  GruLayout L;
  int v = 0;
  const void* ptrs[] = {z, h, ql, out};
  const int err = prepare(&L, &v, strides, 3, ptrs, 4, outer, inner, batch,
                          dtype);
  if (err != 0 || v == 0) return err;
  GRU_DISPATCH(gru_blend_kernel,
               (static_cast<const T*>(z), static_cast<const T*>(h),
                static_cast<const T*>(ql), static_cast<T*>(out), L));
  return (int)cudaGetLastError();
}

extern "C" int gru_gates_bwd_launch(const void* zl, const void* rl,
                                    const void* h, const void* dz,
                                    const void* drh, void* dzl, void* drl,
                                    void* dh, const long long* strides,
                                    long long outer, long long inner,
                                    int batch, int dtype, void* stream) {
  GruLayout L;
  int v = 0;
  const void* ptrs[] = {zl, rl, h, dz, drh, dzl, drl, dh};
  const int err = prepare(&L, &v, strides, 5, ptrs, 8, outer, inner, batch,
                          dtype);
  if (err != 0 || v == 0) return err;
  GRU_DISPATCH(gru_gates_bwd_kernel,
               (static_cast<const T*>(zl), static_cast<const T*>(rl),
                static_cast<const T*>(h), static_cast<const T*>(dz),
                static_cast<const T*>(drh), static_cast<T*>(dzl),
                static_cast<T*>(drl), static_cast<T*>(dh), L));
  return (int)cudaGetLastError();
}

extern "C" int gru_blend_bwd_launch(const void* z, const void* h,
                                    const void* ql, const void* g, void* dz,
                                    void* dh, void* dql,
                                    const long long* strides, long long outer,
                                    long long inner, int batch, int dtype,
                                    void* stream) {
  GruLayout L;
  int v = 0;
  const void* ptrs[] = {z, h, ql, g, dz, dh, dql};
  const int err = prepare(&L, &v, strides, 4, ptrs, 7, outer, inner, batch,
                          dtype);
  if (err != 0 || v == 0) return err;
  GRU_DISPATCH(gru_blend_bwd_kernel,
               (static_cast<const T*>(z), static_cast<const T*>(h),
                static_cast<const T*>(ql), static_cast<const T*>(g),
                static_cast<T*>(dz), static_cast<T*>(dh),
                static_cast<T*>(dql), L));
  return (int)cudaGetLastError();
}

#undef GRU_DISPATCH
