// On-the-fly windowed correlation (the alternate_corr path) for Hopper
// (sm_90a).
//
// Replaces raft_tpu/kernels/corr_alt_pallas.py::_alt_kernel (reached through
// _level_alt_pallas and alt_corr_lookup_pallas). For every query pixel q and
// every pyramid level l it dots fmap1's row (C channels) against fmap2[l] at
// each tap of the (2r+2)^2 integer window around coords[q] / 2^l (taps
// outside the level give 0), applies the separable 2-tap lerp with the
// query's fractions (y first, then x, as the Pallas kernel does), divides by
// sqrt(C) and writes fp32 channels in the x-major order
// c = l*K^2 + x_idx*K + y_idx (K = 2r+1). The (H*W)^2 volume is never built.
// Correlation is linear in fmap2, so dotting the integer taps and then
// lerping equals sampling fmap2 bilinearly and then dotting (the plain
// version, models/corr.py::alt_corr_lookup), up to fp32 rounding.
//
// What bounds it on this card: bytes and shared memory, once the products
// run on the tensor cores. The compulsory traffic is fmap1, the fmap2
// pyramid, coords and the output once (28.3 MB at validate_kitti's 48x160
// grid, C=256, r=4: 8.5 us at 3.35 TB/s); the products are 2*C flops per
// in-range tap (0.94 GFLOP there: 14 us at 67 TFLOP/s on the CUDA cores,
// 5.7 us as three TF32 products each at 495 TFLOP/s). The first design, a
// warp per (query, level) dotting its 100 taps in turn on the CUDA cores,
// read each window column again from L2 for every neighbouring query (nine
// of ten are shared) and ran at ~26x the bound. Staged through shared
// memory, the box a tile needs is read once, but the block still stages
// its fmap1 rows once per chunk, and wgmma reads its shared operand once
// per product of the split.
//
// Design:
// - A block of 512 threads (four warpgroups) owns an 8x8 tile of
//   neighbouring queries of one image at one level; the grid runs over
//   (level, image, tile), level 0 first (its tiles are the heaviest). Tiles
//   on the ragged right and bottom edges are masked; tiles never cross an
//   image of the batch.
// - The block takes each query's window origin (coords clamped to
//   [-(r+2), S+r+1] before the floor, as _prep_coords does: far-out queries
//   give exact zeros and an inf never reaches an int conversion) and the
//   box: the union of the tile's windows clipped to the level. A query whose
//   window misses the level stays out of the box and writes zeros; an empty
//   level has an empty box and is never read.
// - Tiled branch (box of at most BOX_MAX pixels): the box against the tile
//   is a small GEMM, S = F2box (pixels x C) * F1^T (C x 64 queries), in
//   chunks of 256 box pixels, one warpgroup to 64 of them. Each slab of 32
//   channels of the chunk's pixels and of the tile's fmap1 rows (NHWC rows,
//   channels contiguous) is copied by cp.async into a two-stage ring
//   (commit_group / wait_group), laid out as wgmma's K-major core matrices
//   without swizzle (8 rows x 16 bytes each); channels past C are
//   zero-filled, so C need only be a multiple of 4. Products run as
//   wgmma.m64n64k8.f32.tf32.tf32 with the error-compensated split
//   (plain TF32's 10-bit mantissa would break fp32 accuracy): x = big +
//   small, both rounded to TF32 to nearest, three products with the small
//   terms first (p_small*q_big + p_big*q_small + p_big*q_big). The tensor
//   cores' sums round toward zero, so a chain of 96 of them (C=256) biased
//   the dot by ~1e-6 of sum|p||q|, ten times the CUDA cores' error: each
//   slab's 12 products chain in a fresh accumulator, and the slabs add up
//   in fp32 (1.5e-7 of sum|p||q|). The pixels are the
//   register operand (ldmatrix, split in registers); the queries the shared
//   one, split once a slab into a big and a small plane. Each product is
//   kept only where the pixel lies in that query's window: it goes to the
//   query's (2r+2)^2 window in shared memory (each tap written once, no
//   atomics).
// - Per-query branch (box over BOX_MAX pixels: a motion boundary, chaotic
//   flow, scattered queries): the first design, inside the same kernel --
//   each warp takes 4 of the tile's queries, lanes across C in 16-byte
//   loads with the fmap1 row in registers, four taps per round (four loads
//   in flight), shuffle-reduced into the same windows. The choice depends
//   only on the coords; both branches are deterministic.
// - Both branches end in the same epilogue: the separable lerp, /sqrt(C),
//   each query's K^2 outputs written as one contiguous run.
// - Each block adds one to counts[0] (tiled) or counts[1] (per-query), a
//   buffer the wrapper owns; nothing on the path reads it back.
// - The TPU kernel's 2r+3 zero halo, its 8-aligned DMA span (_wspan,
//   _wextra), the _QTILE padding of N and the iota column-select existed for
//   Mosaic's tiling and VMEM; none is needed here.

#include <climits>
#include <cuda_runtime.h>

#include "tf32_wgmma.cuh"

#define RAFT_ALT_MAX_LEVELS 8

namespace {

constexpr int TILE = 8;              // a tile is TILE x TILE queries
constexpr int TQ = TILE * TILE;      // 64 queries: four m16 MMA row blocks
constexpr int NB = 256;              // box pixels per chunk: 4 warpgroups' n64
constexpr int KC = 32;               // channels per staged slab
constexpr int STAGES = 2;            // cp.async ring depth
constexpr int STAGE_FLOATS = (TQ + NB) * KC;
// A slab holds its rows in wgmma's K-major core matrices (tf32_wgmma.cuh)
__device__ __forceinline__ int slab_offset(int row, int k4) {
  return core_offset<KC>(row, k4);
}
constexpr int THREADS = 512;         // one block an SM
// Larger boxes take the per-query branch. A tile's tensor-core time grows
// with its box, the per-query branch's does not; the limit is the best of
// 256-2048 and the two single-branch kernels measured on the smooth and
// i.i.d. fields and on the model's own K5 inputs (profile_corr_alt.py).
constexpr int BOX_MAX = 512;

struct AltLevels {
  const float* f2[RAFT_ALT_MAX_LEVELS];
  int h[RAFT_ALT_MAX_LEVELS];
  int w[RAFT_ALT_MAX_LEVELS];
};

// floor(i / d) for 0 <= i < 2^20 through one float multiply: (i + 0.5) / d
// lies at least 0.5 / d away from an integer, and the multiply by the
// rounded 1/d is off by under (i + 0.5) / d * 2^-22, which is less.
__device__ __forceinline__ int div_small(int i, float inv_d) {
  return (int)(((float)i + 0.5f) * inv_d);
}

template <int V>
__global__ void __launch_bounds__(THREADS, 1)
corr_alt_kernel(const __grid_constant__ AltLevels lv,
                const float* __restrict__ fmap1,
                const float* __restrict__ coords, float* __restrict__ out,
                unsigned long long* __restrict__ counts, int levels, int H,
                int W, int C, int radius, int tiles_x, int tiles_per_level,
                float sqrt_c) {
  extern __shared__ float smem[];
  const int K = 2 * radius + 1;
  const int P = K + 1;
  const int KK = K * K;
  const int PP = P * P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c4 = C >> 2;

  // the windows and their bookkeeping; then, for the tiled branch, the
  // query planes of one slab and the copy ring
  float* win = smem;                                // [TQ][P][P]
  int* ox = reinterpret_cast<int*>(win + TQ * PP);  // window origins
  int* oy = ox + TQ;
  float* fx = reinterpret_cast<float*>(oy + TQ);    // fractions
  float* fy = fx + TQ;
  int* red = reinterpret_cast<int*>(fy + TQ);       // 2 warps x 4 bounds
  float* qbig = reinterpret_cast<float*>(red + 8);  // [TQ x KC], TF32
  float* qsmall = qbig + TQ * KC;                   // the exact rest
  float* ring = qsmall + TQ * KC;                   // [STAGES][(TQ+NB) x KC]

  // -- which tile, level and image ---------------------------------------
  const int l = blockIdx.x / tiles_per_level;
  int rest = blockIdx.x - l * tiles_per_level;
  const int tiles_y = (H + TILE - 1) / TILE;
  const int b = rest / (tiles_y * tiles_x);
  rest -= b * tiles_y * tiles_x;
  const int ty0 = (rest / tiles_x) * TILE;
  const int tx0 = (rest % tiles_x) * TILE;
  const int Hl = lv.h[l];
  const int Wl = lv.w[l];
  const float* f2 = lv.f2[l] + (long long)b * Hl * Wl * C;

  // -- each query's window, and the box ----------------------------------
  if (tid < TQ) {
    const int qy = ty0 + tid / TILE;
    const int qx = tx0 + tid % TILE;
    int x0 = -(1 << 28), y0 = -(1 << 28);  // never matches a box pixel
    float wx = 0.0f, wy = 0.0f;
    int lo_x = INT_MAX, lo_y = INT_MAX, hi_x = INT_MIN, hi_y = INT_MIN;
    if (qy < H && qx < W) {
      const long long q = ((long long)b * H + qy) * W + qx;
      const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
      float x = coords[2 * q] * scale;
      float y = coords[2 * q + 1] * scale;
      x = fminf(fmaxf(x, -(radius + 2.0f)), (float)Wl + radius + 1.0f);
      y = fminf(fmaxf(y, -(radius + 2.0f)), (float)Hl + radius + 1.0f);
      const float xf = floorf(x);
      const float yf = floorf(y);
      x0 = (int)xf - radius;
      y0 = (int)yf - radius;
      wx = x - xf;
      wy = y - yf;
      const int cx0 = max(x0, 0), cx1 = min(x0 + P - 1, Wl - 1);
      const int cy0 = max(y0, 0), cy1 = min(y0 + P - 1, Hl - 1);
      if (cx0 <= cx1 && cy0 <= cy1) {  // the window meets the level
        lo_x = cx0;
        hi_x = cx1;
        lo_y = cy0;
        hi_y = cy1;
      }
    }
    ox[tid] = x0;
    oy[tid] = y0;
    fx[tid] = wx;
    fy[tid] = wy;
    lo_x = __reduce_min_sync(0xffffffffu, lo_x);
    lo_y = __reduce_min_sync(0xffffffffu, lo_y);
    hi_x = __reduce_max_sync(0xffffffffu, hi_x);
    hi_y = __reduce_max_sync(0xffffffffu, hi_y);
    if (lane == 0) {
      red[4 * warp + 0] = lo_x;
      red[4 * warp + 1] = lo_y;
      red[4 * warp + 2] = hi_x;
      red[4 * warp + 3] = hi_y;
    }
  }
  for (int i = tid; i < TQ * PP; i += THREADS) win[i] = 0.0f;
  __syncthreads();
  const int bx0 = min(red[0], red[4]);
  const int by0 = min(red[1], red[5]);
  const int bx1 = max(red[2], red[6]);
  const int by1 = max(red[3], red[7]);
  const int bw = bx0 <= bx1 ? bx1 - bx0 + 1 : 0;
  const int bh = by0 <= by1 ? by1 - by0 + 1 : 0;
  const int npx = bw * bh;  // bw, bh <= the level's sides: no overflow
  const bool tiled = npx <= BOX_MAX;
  if (tid == 0 && counts != nullptr) atomicAdd(&counts[tiled ? 0 : 1], 1ULL);

  if (tiled) {
    // ---- the tile against its box, on the tensor cores -----------------
    const int kchunks = (C + KC - 1) / KC;
    const float inv_bw = 1.0f / (float)max(bw, 1);
    const int total = ((npx + NB - 1) / NB) * kchunks;
    const int wg = warp >> 2;                  // 64 pixels of each chunk
    const int wm = wg * 64 + (warp & 3) * 16;  // this warp's 16 pixels
    const int g = lane >> 2;
    const int t = lane & 3;

    // Each thread copies one 16-byte piece (column jq) of a slab row in each
    // pass of RPP rows: rows rq, rq+RPP.. of the tile's fmap1, then of the
    // box chunk; eight lanes of a warp fill one 128-byte core matrix. The
    // row pointers are taken once (fmap1) or once a chunk (box).
    constexpr int RPP = THREADS / (KC / 4);
    constexpr int APASS = TQ / RPP;
    constexpr int BPASS = NB / RPP;
    const int jq = (tid >> 3) % (KC / 4);
    const int rq = (tid / (8 * (KC / 4))) * 8 + (tid & 7);
    const float* arow[APASS];
    bool aok[APASS];
#pragma unroll
    for (int m = 0; m < APASS; ++m) {
      const int row = rq + m * RPP;
      const int qy = ty0 + row / TILE;
      const int qx = tx0 + row % TILE;
      aok[m] = qy < H && qx < W;
      arow[m] = aok[m] ? fmap1 + (((long long)b * H + qy) * W + qx) * C
                       : fmap1;
    }
    const float* brow[BPASS];
    bool bok[BPASS];
    auto load_stage = [&](int s) {
      float* dst = ring + (s % STAGES) * STAGE_FLOATS;
      const int nc = s / kchunks;
      const int kc = s - nc * kchunks;
      if (kc == 0) {  // a new chunk of box pixels
#pragma unroll
        for (int m = 0; m < BPASS; ++m) {
          const int p = nc * NB + rq + m * RPP;
          const int py = div_small(p, inv_bw);
          bok[m] = p < npx;
          brow[m] = bok[m] ? f2 + ((long long)(by0 + py) * Wl + bx0 + p -
                                   py * bw) * C
                           : f2;
        }
      }
      // Rows of queries outside the image and of pixels past the box are
      // not copied: what they hold reaches only their own row or column of
      // the product, which is never kept. Channels past C are zero-filled:
      // they enter every product.
      const int j = kc * (KC / 4) + jq;  // float4 index in the channel row
      const bool cin = j < c4;
#pragma unroll
      for (int m = 0; m < APASS; ++m) {
        if (aok[m]) {
          cp_async16(dst + slab_offset(rq + m * RPP, jq),
                     cin ? arow[m] + 4 * j : fmap1, cin ? 16 : 0);
        }
      }
#pragma unroll
      for (int m = 0; m < BPASS; ++m) {
        if (bok[m]) {
          cp_async16(dst + slab_offset(TQ + rq + m * RPP, jq),
                     cin ? brow[m] + 4 * j : fmap1, cin ? 16 : 0);
        }
      }
    };

    // the chunk's products (pixels wm + g (+8), queries 8n + 2t (+1)), and
    // one slab's
    float acc[32], part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = part[i] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) load_stage(s);
      cp_async_commit();
    }
    for (int s = 0; s < total; ++s) {
      if (s + STAGES - 1 < total) load_stage(s + STAGES - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncthreads();
      // the queries' rows of the slab as TF32 big and small parts (the
      // box's are split in registers below)
      const float* slab = ring + (s % STAGES) * STAGE_FLOATS;
      for (int i = tid; i < TQ * KC / 4; i += THREADS) {
        const uint4 x = reinterpret_cast<const uint4*>(slab)[i];
        uint4 hi, lo;
        split_tf32(x, hi, lo);
        reinterpret_cast<uint4*>(qbig)[i] = hi;
        reinterpret_cast<uint4*>(qsmall)[i] = lo;
      }
      fence_proxy_async();
      __syncthreads();
      const int nc = s / kchunks;
      if (nc * NB + wg * 64 < npx) {  // uniform in the warpgroup
#pragma unroll
        for (int kk = 0; kk < KC / 4; kk += 2) {  // k8 = two core matrices
          // this warp's 16 pixels at core columns kk (+1), by ldmatrix
          unsigned a[4], ab[4], as[4];
          ldmatrix_x4(a, slab + slab_offset(TQ + wm + ((lane >> 3) & 1) * 8 +
                                                (lane & 7),
                                            kk + (lane >> 4)));
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
          const int q_off = slab_offset(0, kk);
          wgmma_tf32x3(part, ab, as, core_desc<KC>(qbig + q_off),
                       core_desc<KC>(qsmall + q_off), kk > 0);
        }
        wgmma_wait<0>();
        // The tensor cores round their sums toward zero, so their error
        // grows with the products chained in one accumulator: a slab's 12
        // chain there, and the slabs add up here, rounded to nearest.
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += part[i];
      }
      if ((s + 1) % kchunks == 0) {
        // keep each product whose pixel lies in its query's window
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int p = nc * NB + wm + g + ((i >> 1) & 1) * 8;
          const int q = (i >> 2) * 8 + 2 * t + (i & 1);
          if (p < npx) {
            const int py = div_small(p, inv_bw);
            const int dx = bx0 + p - py * bw - ox[q];
            const int dy = by0 + py - oy[q];
            if ((unsigned)dx < (unsigned)P && (unsigned)dy < (unsigned)P) {
              win[q * PP + dy * P + dx] = acc[i];
            }
          }
          acc[i] = 0.0f;
        }
      }
      __syncthreads();  // the slab is refilled STAGES-1 steps later
    }
  } else {
    // ---- per query: lanes across C, four taps per round -----------------
    const float4* f2v = reinterpret_cast<const float4*>(f2);
    for (int q = warp; q < TQ; q += THREADS / 32) {
      const int qy = ty0 + q / TILE;
      const int qx = tx0 + q % TILE;
      if (qy >= H || qx >= W) continue;
      const int x0 = ox[q], y0 = oy[q];
      if (x0 + P <= 0 || x0 >= Wl || y0 + P <= 0 || y0 >= Hl) continue;
      const float4* f1 = reinterpret_cast<const float4*>(fmap1) +
                         (((long long)b * H + qy) * W + qx) * c4;
      float* wq = win + q * PP;
      for (int c0 = 0; c0 < c4; c0 += 32 * V) {
        float4 a[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const int k = c0 + v * 32 + lane;
          a[v] = k < c4 ? f1[k] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        for (int t0 = 0; t0 < PP; t0 += 4) {
          float s[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int tap = t0 + u;
            const int iy = y0 + tap / P;
            const int ix = x0 + tap % P;
            const bool in = tap < PP && iy >= 0 && iy < Hl && ix >= 0 &&
                            ix < Wl;  // uniform in the warp
            const float4* row = f2v + ((long long)iy * Wl + ix) * c4;
            s[u] = 0.0f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const int k = c0 + v * 32 + lane;
              const float4 f = in && k < c4 ? row[k]
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
              s[u] = fmaf(a[v].x, f.x, s[u]);
              s[u] = fmaf(a[v].y, f.y, s[u]);
              s[u] = fmaf(a[v].z, f.z, s[u]);
              s[u] = fmaf(a[v].w, f.w, s[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) {
              s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
            }
          }
          if (lane == 0) {
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (t0 + u < PP) wq[t0 + u] = c0 == 0 ? s[u] : wq[t0 + u] + s[u];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- the separable lerp, y then x, /sqrt(C), x-major channels ----------
  const long long channels = (long long)levels * KK;
  const float inv_kk = 1.0f / (float)KK;
  const float inv_k = 1.0f / (float)K;
  for (int i = tid; i < TQ * KK; i += THREADS) {
    const int q = div_small(i, inv_kk);
    const int tap = i - q * KK;
    const int qy = ty0 + q / TILE;
    const int qx = tx0 + q % TILE;
    if (qy >= H || qx >= W) continue;
    const int xi = div_small(tap, inv_k);  // x-major: x is the outer index
    const int yi = tap - xi * K;
    const float* r0 = win + q * PP + yi * P + xi;
    const float wx = fx[q], wy = fy[q];
    const float lo = (1.0f - wy) * r0[0] + wy * r0[P];
    const float hi = (1.0f - wy) * r0[1] + wy * r0[P + 1];
    out[(((long long)b * H + qy) * W + qx) * channels + (long long)l * KK +
        tap] = ((1.0f - wx) * lo + wx * hi) / sqrt_c;
  }
}

}  // namespace

// Dynamic shared memory of one block at this radius: the windows and their
// bookkeeping, the query planes of one slab and the copy ring.
extern "C" long long corr_alt_smem_bytes(int radius) {
  const long long P = 2LL * radius + 2;
  return (TQ * P * P + 4 * TQ + 8 + 2LL * TQ * KC +
          (long long)STAGES * STAGE_FLOATS) *
         4;
}

extern "C" int corr_alt_launch(const void* const* f2s, const int* hs,
                               const int* ws, int levels, const void* fmap1,
                               const void* coords, void* out, int batch,
                               int H, int W, int c, int radius, float sqrt_c,
                               void* counts, void* stream) {
  if (levels < 1 || levels > RAFT_ALT_MAX_LEVELS || radius < 1 ||
      batch < 0 || H < 0 || W < 0 || c < 4 || c % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  AltLevels lv;
  for (int l = 0; l < RAFT_ALT_MAX_LEVELS; ++l) {
    lv.f2[l] = l < levels ? static_cast<const float*>(f2s[l]) : nullptr;
    lv.h[l] = l < levels ? hs[l] : 0;
    lv.w[l] = l < levels ? ws[l] : 0;
  }
  const long long tiles_x = (W + TILE - 1) / TILE;
  const long long tiles = (long long)batch * ((H + TILE - 1) / TILE) * tiles_x;
  const long long blocks = tiles * levels;
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const long long smem = corr_alt_smem_bytes(radius);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > optin) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f1 = static_cast<const float*>(fmap1);
  const float* xy = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  unsigned long long* n = static_cast<unsigned long long*>(counts);
  cudaError_t err;
  if (c <= 128) {
    err = set_smem(corr_alt_kernel<1>, smem);
    if (err != cudaSuccess) return (int)err;
    corr_alt_kernel<1><<<(unsigned)blocks, THREADS, smem, s>>>(
        lv, f1, xy, o, n, levels, H, W, c, radius, (int)tiles_x, (int)tiles,
        sqrt_c);
  } else {
    err = set_smem(corr_alt_kernel<2>, smem);
    if (err != cudaSuccess) return (int)err;
    corr_alt_kernel<2><<<(unsigned)blocks, THREADS, smem, s>>>(
        lv, f1, xy, o, n, levels, H, W, c, radius, (int)tiles_x, (int)tiles,
        sqrt_c);
  }
  return (int)cudaGetLastError();
}
