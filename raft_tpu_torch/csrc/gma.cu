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
// A once, 4.2 GB (1.27 ms at 3.35 TB/s; 1.40 ms at the measured 3.03 TB/s),
// against 0.27 TFLOP of products, which float32 accuracy would put at 4.0 ms
// on the CUDA cores (67 TFLOP/s). On the tensor cores, in the
// error-compensated TF32 split of tf32_wgmma.cuh (three TF32 products, 0.81
// TFLOP: 1.63 ms at 495 TFLOP/s, 2.06 ms at the measured 391), the products
// bound K7 a little above the bytes: K7 reads A once a step with the tensor
// cores fed; K6 forms each logit once.
//
// Design, shared: the products are wgmma with a register operand split into
// TF32 big and small parts and a shared operand split once into a big and a
// small plane in wgmma's K-major core-matrix layout. Products chain in a
// fresh accumulator for one slab of 32 reduction elements (12 products: the
// tensor cores round their sums toward zero) and the slabs add up in fp32.
// Reads past N are zero-filled. Offsets are 64-bit: B * N^2 passes 2^31 at
// 1080p.
//
// K6: a block is one warpgroup and owns 64 queries; their rows, scaled and
// split, sit in shared memory for the whole launch and are the register
// operand (each warp its 16 queries, by ldmatrix). The keys stream through
// a three-stage cp.async ring, 64 keys x 32 channels a stage, split into
// planes: the shared operand (wgmma.m64n64k8). Each thread holds two
// queries' logits against 16 of a step's 64 keys: it writes them into A
// (four lanes a row's 32 bytes) and keeps its two rows' running maximum and
// sum of exponentials (the online softmax).
// After the one sweep over the keys the statistics merge across the four
// lanes of a row, and the block normalises its rows in place,
// exp(s - max) / sum: A is written twice and read once (12.6 GB at 1080p),
// where a second sweep would form every logit again. Two blocks share an
// SM.
//
// K7: a warp-specialised pipeline; a block owns 128 rows of A and all 128
// channels of g, with three warpgroups and no block barrier in its loop:
//   - warp 0 (one thread) keeps a four-stage ring of bulk tensor copies
//     (TMA) in flight, each stage A's slab of the block's rows x 32 keys
//     (128-byte swizzled rows; L2 evict-first, as A is read once) and v's
//     32 rows (evict-last, as every block reads all of v, 16.6 MB a pair),
//     each stage's bytes and each release counted on an mbarrier;
//   - warps 1-3 transpose and split each slab of v into K-major big and
//     small planes (a two-plane ring), once for the block: a lane reads a
//     4 x 4 block (4 keys of 4 channels) and stores its 4 channels; the
//     planes' groups of 8 channels lie 16 bytes further apart than their
//     data, so those stores hit every bank;
//   - two consumer warpgroups, 64 rows each, load their A fragments by
//     ldmatrix, split them in registers (A never goes through planes), then
//     issue the slab's 12 wgmma.m64n128k8 (N = the 128 channels) on the
//     planes, wait, add the chain into the fp32 total and free the planes.
// setmaxnreg gives the consumers 232 registers a thread (two 64-float
// accumulators and the slab's 32 fragment registers, which must stay
// unchanged until the products retire) and the producers 40. A wait_group
// 1 ping-pong within a warpgroup would hold two slabs' fragments beside
// three accumulators, over 255 registers; the two consumer warpgroups take
// turns on the tensor cores instead, one adding while the other's products
// run. v is read from L2 once a block (4.2 GB a step at 1080p, half as
// much as with 64-row blocks). The epilogue adds gamma times the product
// to m. One block an SM (198,752 bytes of shared memory).
//
// What now bounds K7 (H100 SXM at 700 W, batch 1 at 1080p's grid): shared
// memory. A slab moves 192 KB through it: wgmma's reads of the planes (96
// KB), v's copy, read-back and planes (64 KB), A's copy and ldmatrix (32
// KB). Without v's transpose-split (a diagnostic copy) a launch takes
// 1.9-2.0 ms, the products at ~85% of 495 TFLOP/s, near the 2.06 ms
// compute floor at the measured TF32 envelope; with it 2.4-2.6 ms. Fewer
// bytes through shared memory a row would need more rows a block, and the
// registers hold no more (256 rows spill).
//
// A's rows must start 16 bytes apart (the wrapper gives K6's output a row
// stride that is a multiple of 4); q, k and v likewise; m and g any row
// stride. The C functions return a CUDA error code, 0 on success.

#include <cuda.h>
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
constexpr int AG_ROWS = 128;             // rows of A a block
constexpr int AG_THREADS = 384;          // a producer and two consumer groups
constexpr int AG_STAGES = 4;             // ring of A and v slabs
constexpr int AG_PLANES = 2;             // ring of v's big and small planes
constexpr int AG_SPLITTERS = 3;          // warps 1-3: v's transpose-split
constexpr int AG_CONSUMER_WARPS = 8;
constexpr int AG_A = AG_ROWS * KC;       // floats of a stage's A slab
constexpr int AG_V = KC * D;             // floats of a stage's v slab
constexpr int AG_STAGE = AG_A + AG_V;
// floats between a plane's groups of 8 channels: their 8 core matrices and
// 16 bytes more, so that the 8 lanes of a quarter-warp, each storing one
// channel of its 4 x 4 block, hit 8 different 16-byte bank groups
constexpr int AG_SBO = 8 * KC + 4;
constexpr int AG_PLANE = (D / 8) * AG_SBO;   // floats of one plane
constexpr int AG_BARS = 2 * AG_STAGES + 2 * AG_PLANES;
constexpr long long AG_SMEM =            // 1024 bytes to align the ring
    1024 + (AG_STAGES * (long long)AG_STAGE + AG_PLANES * 2LL * AG_PLANE) * 4 +
    AG_BARS * 8;
constexpr int AG_PRODUCER_REGS = 40;     // with 232 a consumer thread: the
constexpr int AG_CONSUMER_REGS = 232;    // 168 x 384 of the launch
static_assert(AG_PRODUCER_REGS * 128 + AG_CONSUMER_REGS * 256 <= 168 * 384,
              "setmaxnreg moves no more registers than the launch holds");
static_assert(KC * 4 == 128, "an A slab's row is one 128-byte swizzle span");

struct OutStrides {
  long long mb, mn, gb, gn;
};

__global__ void __launch_bounds__(AG_THREADS, 1)
gma_aggregate_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const float* __restrict__ m, float* __restrict__ out,
                     const float* __restrict__ gamma, int N,
                     const OutStrides st) {
  extern __shared__ __align__(1024) unsigned char ag_smem[];
  float* ring = reinterpret_cast<float*>(
      ag_smem + ((1024 - (smem_u32(ag_smem) & 1023)) & 1023));
  float* planes = ring + AG_STAGES * AG_STAGE;  // [AG_PLANES][big, small]
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      planes + AG_PLANES * 2 * AG_PLANE);
  unsigned long long* empty = full + AG_STAGES;
  unsigned long long* pfull = empty + AG_STAGES;
  unsigned long long* pempty = pfull + AG_PLANES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * AG_ROWS;
  const int T = (N + KC - 1) / KC;         // slabs of 32 keys

  if (tid == 0) {
    for (int s = 0; s < AG_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, AG_SPLITTERS + AG_CONSUMER_WARPS);
    }
    for (int p = 0; p < AG_PLANES; ++p) {
      mbar_init(pfull + p, AG_SPLITTERS);
      mbar_init(pempty + p, AG_CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp < 4) {
    // -- the producer warpgroup ---------------------------------------------
    setmaxnreg_dec<AG_PRODUCER_REGS>();
    if (warp == 0) {
      // one thread keeps the ring's bulk copies in flight: A's slab (rows x
      // 32 keys, swizzled, evict first) and v's 32 rows (evict last)
      if (lane == 0) {
        const unsigned long long first = l2_evict_first();
        const unsigned long long last = l2_evict_last();
        for (int i = 0; i < T; ++i) {
          const int s = i % AG_STAGES;
          mbar_wait(empty + s, ((i / AG_STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(full + s, AG_STAGE * 4);
          float* dst = ring + s * AG_STAGE;
          tma_load_3d(dst, &a_map, full + s, i * KC, row0, b, first);
          tma_load_3d(dst + AG_A, &v_map, full + s, 0, i * KC, b, last);
        }
      }
    } else {
      // warps 1-3: each slab's v (32 keys x 128 channels, row-major) into
      // K-major TF32 big and small planes, once for both consumers; a warp
      // takes 4 keys of all channels at a time, a lane a 4 x 4 block
      const int tw = warp - 1;
      const int c4 = 4 * lane;
      int off[4];                          // channel c4 + q's 16 bytes
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        off[q] = ((c4 + q) >> 3) * AG_SBO + ((c4 + q) & 7) * 4;
      }
      for (int i = 0; i < T; ++i) {
        const int s = i % AG_STAGES;
        const int p = i % AG_PLANES;
        mbar_wait(pempty + p, ((i / AG_PLANES) & 1) ^ 1);
        mbar_wait(full + s, (i / AG_STAGES) & 1);
        const float* vs = ring + s * AG_STAGE + AG_A;
        float* big = planes + p * 2 * AG_PLANE;
        for (int k4 = tw; k4 < KC / 4; k4 += AG_SPLITTERS) {
          float4 x[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            x[r] = *reinterpret_cast<const float4*>(vs + (4 * k4 + r) * D + c4);
          }
          split_tf32_4x4(x, big + k4 * 32, big + AG_PLANE + k4 * 32, off);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(pfull + p);
          mbar_arrive(empty + s);
        }
      }
    }
  } else {
    // -- two consumer warpgroups, 64 rows each --------------------------------
    setmaxnreg_inc<AG_CONSUMER_REGS>();
    const int cw = (warp >> 2) - 1;
    const int wq = warp & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    // the row this lane addresses for ldmatrix: matrices (rows 0-7 | 8-15)
    // x (k4, k4 + 1) of the warp's 16 rows
    const int arow = 64 * cw + 16 * wq + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int ak4 = lane >> 4;
    float acc[64], part[64];
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.0f;
    for (int i = 0; i < T; ++i) {
      const int s = i % AG_STAGES;
      const int p = i % AG_PLANES;
      // A's fragments (rows of this warp, the slab's 32 keys), split in
      // registers; the stage is then free as far as this warp goes
      mbar_wait(full + s, (i / AG_STAGES) & 1);
      const unsigned char* as =
          reinterpret_cast<const unsigned char*>(ring + s * AG_STAGE);
      unsigned abig[4][4], asmall[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned a[4];
        ldmatrix_x4(a, reinterpret_cast<const float*>(
                           as + swizzle128_offset(arow, 2 * kk + ak4)));
#pragma unroll
        for (int r = 0; r < 4; ++r) split_tf32(a[r], abig[kk][r], asmall[kk][r]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      // 12 products into a fresh chain, added into the fp32 total
      mbar_wait(pfull + p, (i / AG_PLANES) & 1);
      const float* big = planes + p * 2 * AG_PLANE;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* b0 = big + 2 * kk * 32;  // k4 = 2kk: 128 bytes a k4
        wgmma_tf32x3_n128(part, abig[kk], asmall[kk],
                          kmajor_desc(b0, 128, AG_SBO * 4),
                          kmajor_desc(b0 + AG_PLANE, 128, AG_SBO * 4),
                          kk > 0);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] += part[r];
      __syncwarp();
      if (lane == 0) mbar_arrive(pempty + p);
    }

    // acc[i]: channel 8 * (i >> 2) + 2t + (i & 1) of row 16 * wq + g + 8 *
    // ((i >> 1) & 1) of the warpgroup's 64
    const float gm = *gamma;
    m += b * st.mb;
    out += b * st.gb;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = row0 + 64 * cw + 16 * wq + g + 8 * ((i >> 1) & 1);
      const int ch = 8 * (i >> 2) + 2 * t + (i & 1);
      if (r < N) out[r * st.gn + ch] = m[r * st.mn + ch] + gm * acc[i];
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (batch, rows, inner) float32 tensor's map for boxes of (1, box1, box0):
// strides in elements; reads outside it are zeros
bool encode_map(CUtensorMap* map, const void* ptr, long long inner,
                long long rows, int batch, long long row_stride,
                long long batch_stride, unsigned box0, unsigned box1,
                CUtensorMapSwizzle swizzle, CUtensorMapL2promotion promote) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  // one batch: any legal stride for the unused dimension
  const cuuint64_t strides[2] = {
      (cuuint64_t)row_stride * 4,
      (cuuint64_t)(batch > 1 ? batch_stride : rows * row_stride) * 4};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, promote,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  const long long ab = strides[0], an = strides[1], vb = strides[2],
                  vn = strides[3];
  const OutStrides st{strides[4], strides[5], strides[6], strides[7]};
  if (batch < 0 || batch > 65535 || n < 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n == 0) return 0;
  if (!aligned16(attn, an) || !aligned16(v, vn) || ab % 4 != 0 ||
      vb % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap a_map, v_map;
  if (!encode_map(&a_map, attn, n, n, batch, an, ab, KC, AG_ROWS,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B) ||
      !encode_map(&v_map, v, D, n, batch, vn, vb, D, KC,
                  CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = set_smem(gma_aggregate_kernel, AG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + AG_ROWS - 1) / AG_ROWS), (unsigned)batch);
  gma_aggregate_kernel<<<grid, AG_THREADS, AG_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      a_map, v_map, static_cast<const float*>(m), static_cast<float*>(out),
      static_cast<const float*>(gamma), n, st);
  return (int)cudaGetLastError();
}

// K7's resident blocks an SM and its dynamic shared memory a block
extern "C" int gma_aggregate_occupancy(int* blocks_per_sm,
                                       long long* smem_bytes) {
  cudaError_t err = set_smem(gma_aggregate_kernel, AG_SMEM);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = AG_SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gma_aggregate_kernel, AG_THREADS, AG_SMEM);
}
