// GMA's global motion aggregation for Hopper (sm_90a): the attention (K6)
// and the aggregation (K7).
//
// They replace no Pallas kernel: the JAX package runs RAFT alone. They came
// with the port's GMA model (models/gma.py; Jiang et al., "Learning to
// Estimate Hidden Motions with Global Motion Aggregation", ICCV 2021), whose
// attention spans all N positions of the 1/8 grid, with D = 128 channels:
//   K6 (gma_attention_kernel): A = softmax_rows((scale * q) k^T), q and k
//      (B, N, D), A (B, N, N) float32; once a pair.
//   K7 (gma_aggregate_kernel): g = m + gamma * (A v), v and m (B, N, D), g
//      dense (B, N, D); every refinement step. gamma is one float on the
//      device, so a captured graph reads the live weight.
//
// What bounds them on this card, at 1080p's grid (N = 32,400): each moves
// A once, 4.2 GB (1.26 ms at 3.35 TB/s), against 0.27 TFLOP of products,
// which float32 accuracy would put at 4.0 ms on the CUDA cores (67 TFLOP/s).
// On the tensor cores, in the error-compensated TF32 split of
// tf32_wgmma.cuh (three TF32 products, 1.6 ms at 495 TFLOP/s), bytes and
// products come out close: K7 reads A once a step with the tensor cores
// fed; K6 forms each logit once.
//
// Design, shared: each warpgroup issues wgmma.m64n64k8 with its register
// operand from shared memory by ldmatrix or plain loads and its shared
// operand split once a slab into a big and a small plane. Operands arrive
// by cp.async, 16 bytes a copy, into wgmma's core-matrix layout; reads past
// N are zero-filled. Products chain in a fresh accumulator for one slab of
// 32 reduction elements (12 products: the tensor cores round their sums
// toward zero) and the slabs add up in fp32. Offsets are 64-bit: B * N^2
// passes 2^31 at 1080p.
//
// K6: a block is one warpgroup and owns 64 queries; their rows, scaled and
// split, sit in shared memory for the whole launch and are the register
// operand (each warp its 16 queries). The keys stream through a three-stage
// ring, 64 keys x 32 channels a stage, split into planes: the shared
// operand. Each thread holds two queries' logits against 16 of a step's 64
// keys: it writes them into A (four lanes a row's 32 bytes) and keeps its
// two rows' running maximum and sum of exponentials (the online softmax).
// After the one sweep over the keys the statistics merge across the four
// lanes of a row, and the block normalises its rows in place,
// exp(s - max) / sum: A is written twice and read once (12.6 GB at 1080p),
// where a second sweep would form every logit again. Two blocks share an
// SM.
//
// K7: a block is two warpgroups and owns 64 rows of A and all 128
// channels. A stage is a slab of those rows over 32 keys (the shared
// operand, split in shared memory) and the 32 keys' rows of v (32 x 128,
// padded rows so that each warp's fragment loads hit 32 banks). v is the
// register operand transposed: each warpgroup forms (A v)^T for 64 channels
// x the 64 rows. A is read once a step; v (16.6 MB at 1080p) is read by
// every block from L2. The epilogue adds gamma times the product to m.
//
// A's rows must start 16 bytes apart (the wrapper gives K6's output a row
// stride that is a multiple of 4); q, k and v likewise; m and g any row
// stride. The C functions return a CUDA error code, 0 on success.

#include <cuda_runtime.h>

#include "tf32_wgmma.cuh"

namespace {

constexpr int D = 128;        // channels: dim_head, the context width
constexpr int KC = 32;        // reduction elements a slab

// ---- K6 ------------------------------------------------------------------
constexpr int AT_THREADS = 128;          // one warpgroup
constexpr int AT_Q = 64;                 // queries a block (wgmma's M)
constexpr int AT_K = 64;                 // keys a step (wgmma's N)
constexpr int AT_STAGES = 3;
constexpr int AT_SLAB = AT_K * KC;       // floats of a stage
constexpr int AT_PLANE = AT_Q * D;       // floats of a query plane
constexpr long long AT_SMEM =
    (2LL * AT_PLANE + 2 * AT_SLAB + AT_STAGES * AT_SLAB) * 4;
static_assert((2 + AT_STAGES) * AT_SLAB >= AT_PLANE,
              "the key planes and the ring stage the queries");

struct AttnStrides {
  long long qb, qn, kb, kn, ab, an;
};

__global__ void __launch_bounds__(AT_THREADS, 2)
gma_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     float* __restrict__ attn, int N, float scale,
                     const AttnStrides st) {
  extern __shared__ __align__(128) float smem[];
  float* qbig = smem;                      // [AT_Q x D], core layout
  float* qsmall = qbig + AT_PLANE;
  float* kbig = qsmall + AT_PLANE;         // [AT_K x KC], core layout
  float* ksmall = kbig + AT_SLAB;
  float* ring = ksmall + AT_SLAB;          // [AT_STAGES][AT_K x KC]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long b = blockIdx.y;
  const int q0 = blockIdx.x * AT_Q;
  q += b * st.qb;
  k += b * st.kb;
  attn += b * st.ab;

  // -- the block's queries, scaled, as TF32 big and small planes (staged
  // where the key planes and the ring go) ---------------------------------
  for (int i = tid; i < AT_PLANE / 4; i += AT_THREADS) {
    const int row = (i / (2 * D)) * 8 + (i & 7);
    const int j = (i >> 3) % (D / 4);
    const bool ok = q0 + row < N;
    cp_async16(kbig + 4 * i, ok ? q + (q0 + row) * st.qn + 4 * j : q,
               ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < AT_PLANE / 4; i += AT_THREADS) {
    const float4 x = reinterpret_cast<const float4*>(kbig)[i];
    uint4 hi, lo;
    split_tf32(make_uint4(__float_as_uint(x.x * scale),
                          __float_as_uint(x.y * scale),
                          __float_as_uint(x.z * scale),
                          __float_as_uint(x.w * scale)),
               hi, lo);
    reinterpret_cast<uint4*>(qbig)[i] = hi;
    reinterpret_cast<uint4*>(qsmall)[i] = lo;
  }
  __syncthreads();

  // stage s of a sweep: keys of step s / 4, channels 32 * (s % 4)
  const int steps = (N + AT_K - 1) / AT_K;
  const int T = steps * (D / KC);
  auto load_stage = [&](int s) {
    float* dst = ring + (s % AT_STAGES) * AT_SLAB;
    const int sw = s % T;
    const int key0 = (sw / (D / KC)) * AT_K;
    const int c0 = (sw % (D / KC)) * KC;
#pragma unroll
    for (int u = 0; u < AT_SLAB / 4 / AT_THREADS; ++u) {
      const int i = tid + u * AT_THREADS;
      const int key = key0 + (i / (2 * KC)) * 8 + (i & 7);
      const int j = (i >> 3) % (KC / 4);
      const bool ok = key < N;
      cp_async16(dst + 4 * i, ok ? k + key * st.kn + c0 + 4 * j : k,
                 ok ? 16 : 0);
    }
  };

  // this thread's queries: rows 16 * warp + g (+8) of the block
  const int qrow = 16 * warp + g;
  float acc[32], part[32];
  float run_max[2] = {-INFINITY, -INFINITY}, run_sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < AT_STAGES - 1; ++s) {
    if (s < T) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < T; ++s) {
    if (s + AT_STAGES - 1 < T) load_stage(s + AT_STAGES - 1);
    cp_async_commit();
    cp_async_wait<AT_STAGES - 1>();
    __syncthreads();
    // the slab's keys as TF32 big and small planes
    const float* slab = ring + (s % AT_STAGES) * AT_SLAB;
#pragma unroll
    for (int u = 0; u < AT_SLAB / 4 / AT_THREADS; ++u) {
      const int i = tid + u * AT_THREADS;
      uint4 hi, lo;
      split_tf32(reinterpret_cast<const uint4*>(slab)[i], hi, lo);
      reinterpret_cast<uint4*>(kbig)[i] = hi;
      reinterpret_cast<uint4*>(ksmall)[i] = lo;
    }
    fence_proxy_async();
    __syncthreads();
    const int c = s % (D / KC);
#pragma unroll
    for (int kk = 0; kk < KC / 4; kk += 2) {  // k8 = two core matrices
      unsigned qb[4], qs[4];
      const int off = core_offset<D>(16 * warp + ((lane >> 3) & 1) * 8 +
                                         (lane & 7),
                                     c * (KC / 4) + kk + (lane >> 4));
      ldmatrix_x4(qb, qbig + off);
      ldmatrix_x4(qs, qsmall + off);
      const int koff = core_offset<KC>(0, kk);
      wgmma_tf32x3(part, qb, qs, core_desc<KC>(kbig + koff),
                   core_desc<KC>(ksmall + koff), kk > 0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = c == 0 ? part[i] : acc[i] + part[i];
    if (c == D / KC - 1) {
      // acc[i]: the logit of query qrow + 8 * ((i >> 1) & 1) and key
      // key0 + 8 * (i >> 2) + 2t + (i & 1): into the running statistics,
      // and into A
      const int key0 = (s / (D / KC)) * AT_K + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (key0 + 8 * (j >> 1) + (j & 1) < N) {
            mx = fmaxf(mx, acc[(j >> 1) * 4 + 2 * h + (j & 1)]);
          }
        }
        if (mx > run_max[h]) {
          run_sum[h] *= expf(run_max[h] - mx);
          run_max[h] = mx;
        }
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (key0 + 8 * (j >> 1) + (j & 1) < N) {
            sum += expf(acc[(j >> 1) * 4 + 2 * h + (j & 1)] - run_max[h]);
          }
        }
        run_sum[h] += sum;
        const int r = q0 + qrow + 8 * h;
        if (r < N) {
          float* row = attn + r * st.an;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = key0 + 8 * j;
            if (key + 1 < N) {
              *reinterpret_cast<float2*>(row + key) =
                  make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            } else if (key < N) {
              row[key] = acc[4 * j + 2 * h];
            }
          }
        }
      }
    }
    __syncthreads();  // the planes and the stage are written again
  }

  // -- each row's maximum and sum, across the four lanes that share it; then
  // the block's rows normalised in place, exp(s - max) / sum -------------
  float* rmax = kbig;                      // [AT_Q]
  float* rinv = rmax + AT_Q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, run_max[h], o);
      const float os = __shfl_xor_sync(0xffffffffu, run_sum[h], o);
      const float mx = fmaxf(run_max[h], om);
      run_sum[h] = mx == -INFINITY ? 0.0f
                                   : run_sum[h] * expf(run_max[h] - mx) +
                                         os * expf(om - mx);
      run_max[h] = mx;
    }
    if (t == 0) {
      rmax[qrow + 8 * h] = run_max[h];
      rinv[qrow + 8 * h] = 1.0f / run_sum[h];
    }
  }
  __syncthreads();  // the statistics, and the logits the block wrote
  const int n4 = (N + 3) / 4;  // the row stride pads N to a multiple of 4
  const int rows = min(AT_Q, N - q0);
  for (int r = 0; r < rows; ++r) {
    float4* row = reinterpret_cast<float4*>(attn + (q0 + r) * st.an);
    const float m = rmax[r], inv = rinv[r];
    for (int j = tid; j < n4; j += AT_THREADS) {
      float4 x = row[j];
      x.x = expf(x.x - m) * inv;
      x.y = expf(x.y - m) * inv;
      x.z = expf(x.z - m) * inv;
      x.w = expf(x.w - m) * inv;
      row[j] = x;
    }
  }
}

// ---- K7 ------------------------------------------------------------------
constexpr int AG_THREADS = 256;          // two warpgroups
constexpr int AG_ROWS = 64;              // rows of A a block (wgmma's N)
constexpr int AG_STAGES = 3;
constexpr int VS = D + 8;                // v's padded row in a stage
constexpr int AG_A = AG_ROWS * KC;       // floats of a stage's A slab
constexpr int AG_STAGE = AG_A + KC * VS;
constexpr long long AG_SMEM = (2LL * AG_A + AG_STAGES * AG_STAGE) * 4;

struct AggStrides {
  long long ab, an, vb, vn, mb, mn, gb, gn;
};

__global__ void __launch_bounds__(AG_THREADS, 2)
gma_aggregate_kernel(const float* __restrict__ attn,
                     const float* __restrict__ v, const float* __restrict__ m,
                     float* __restrict__ out, const float* __restrict__ gamma,
                     int N, const AggStrides st) {
  extern __shared__ __align__(128) float smem[];
  float* abig = smem;                      // [AG_ROWS x KC], core layout
  float* asmall = abig + AG_A;
  float* ring = asmall + AG_A;             // [AG_STAGES][A slab, v rows]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int ch0 = (warp >> 2) * 64 + (warp & 3) * 16;  // 16 channels a warp
  const long long b = blockIdx.y;
  const int row0 = blockIdx.x * AG_ROWS;
  attn += b * st.ab;
  v += b * st.vb;
  m += b * st.mb;
  out += b * st.gb;

  const int T = (N + KC - 1) / KC;
  auto load_stage = [&](int s) {
    float* dst = ring + (s % AG_STAGES) * AG_STAGE;
    const int key0 = s * KC;
#pragma unroll
    for (int u = 0; u < AG_A / 4 / AG_THREADS; ++u) {
      const int i = tid + u * AG_THREADS;
      const int r = row0 + (i / (2 * KC)) * 8 + (i & 7);
      const int key = key0 + 4 * ((i >> 3) % (KC / 4));
      const int bytes = r < N ? max(0, min(16, 4 * (N - key))) : 0;
      cp_async16(dst + 4 * i, bytes ? attn + r * st.an + key : attn, bytes);
    }
    float* vt = dst + AG_A;
#pragma unroll
    for (int u = 0; u < KC * D / 4 / AG_THREADS; ++u) {
      const int i = tid + u * AG_THREADS;
      const int kr = i / (D / 4);
      const int j = i % (D / 4);
      const bool ok = key0 + kr < N;
      cp_async16(vt + kr * VS + 4 * j, ok ? v + (key0 + kr) * st.vn + 4 * j : v,
                 ok ? 16 : 0);
    }
  };

  float acc[32], part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < AG_STAGES - 1; ++s) {
    if (s < T) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < T; ++s) {
    if (s + AG_STAGES - 1 < T) load_stage(s + AG_STAGES - 1);
    cp_async_commit();
    cp_async_wait<AG_STAGES - 1>();
    __syncthreads();
    const float* slab = ring + (s % AG_STAGES) * AG_STAGE;
    // the A slab as TF32 big and small planes
#pragma unroll
    for (int u = 0; u < AG_A / 4 / AG_THREADS; ++u) {
      const int i = tid + u * AG_THREADS;
      uint4 hi, lo;
      split_tf32(reinterpret_cast<const uint4*>(slab)[i], hi, lo);
      reinterpret_cast<uint4*>(abig)[i] = hi;
      reinterpret_cast<uint4*>(asmall)[i] = lo;
    }
    fence_proxy_async();
    __syncthreads();
    const float* vt = slab + AG_A;
#pragma unroll
    for (int kk = 0; kk < KC / 4; kk += 2) {  // keys 4kk .. 4kk + 7
      // v^T's fragment: channels ch0 + g (+8), keys 4kk + t (+4)
      const float* v0 = vt + (4 * kk + t) * VS + ch0 + g;
      unsigned a[4], ab[4], as[4];
      a[0] = __float_as_uint(v0[0]);
      a[1] = __float_as_uint(v0[8]);
      a[2] = __float_as_uint(v0[4 * VS]);
      a[3] = __float_as_uint(v0[4 * VS + 8]);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
      const int off = core_offset<KC>(0, kk);
      wgmma_tf32x3(part, ab, as, core_desc<KC>(abig + off),
                   core_desc<KC>(asmall + off), kk > 0);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += part[i];
    __syncthreads();  // the planes and the stage are written again
  }

  // acc[i]: channel ch0 + g + 8 * ((i >> 1) & 1) of row 8 * (i >> 2) + 2t +
  // (i & 1) of the block
  const float gm = *gamma;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int ch = ch0 + g + 8 * ((i >> 1) & 1);
    const int r = row0 + 8 * (i >> 2) + 2 * t + (i & 1);
    if (r < N) out[r * st.gn + ch] = m[r * st.mn + ch] + gm * acc[i];
  }
}

bool aligned16(const void* p, long long n) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && n % 4 == 0;
}

}  // namespace

// strides (elements): q's batch and row, k's, attn's
extern "C" int gma_attention_launch(const void* q, const void* k, void* attn,
                                    int batch, int n, float scale,
                                    const long long* strides, void* stream) {
  const AttnStrides st{strides[0], strides[1], strides[2],
                       strides[3], strides[4], strides[5]};
  if (batch < 0 || batch > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  if (!aligned16(q, st.qn) || !aligned16(k, st.kn) || st.qb % 4 != 0 ||
      st.kb % 4 != 0 || !aligned16(attn, st.an) || st.ab % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = set_smem(gma_attention_kernel, AT_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + AT_Q - 1) / AT_Q), (unsigned)batch);
  gma_attention_kernel<<<grid, AT_THREADS, AT_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(attn), n, scale, st);
  return (int)cudaGetLastError();
}

// strides (elements): attn's batch and row, v's, m's, out's
extern "C" int gma_aggregate_launch(const void* attn, const void* v,
                                    const void* m, void* out,
                                    const void* gamma, int batch, int n,
                                    const long long* strides, void* stream) {
  const AggStrides st{strides[0], strides[1], strides[2], strides[3],
                      strides[4], strides[5], strides[6], strides[7]};
  if (batch < 0 || batch > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  if (!aligned16(attn, st.an) || !aligned16(v, st.vn) || st.ab % 4 != 0 ||
      st.vb % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = set_smem(gma_aggregate_kernel, AG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + AG_ROWS - 1) / AG_ROWS), (unsigned)batch);
  gma_aggregate_kernel<<<grid, AG_THREADS, AG_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(attn), static_cast<const float*>(v),
      static_cast<const float*>(m), static_cast<float*>(out),
      static_cast<const float*>(gamma), n, st);
  return (int)cudaGetLastError();
}
