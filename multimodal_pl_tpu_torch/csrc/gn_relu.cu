// GroupNorm for Hopper over an NDHWC bf16 tensor viewed as (B, S, C), S the
// voxels of a sample: GroupNorm -> ReLU forward and backward (training and
// every gradient-free GroupNorm -> ReLU of serving), and the GroupNorm fold
// rows of the fused conv's prologue (inference).
//
// Replaces
//   - multimodal_pl_tpu/ops/pallas/fused_gn_relu.py::fused_group_norm_relu
//     (its _stats_kernel and _norm_kernel): gn_relu_fwd_bf16,
//     y = bf16(relu(((f32(x) - mean) * inv) * s + t)) with s, t the affine
//     rounded to bf16 first (the JAX model casts the affine to the
//     activations' dtype), rounded op by op (no FMA contraction); it also
//     writes the per-(sample, group) mean and inv (B, 2, G) for the backward;
//   - the gradient of that kernel, multimodal_pl_tpu/ops/norm.py:95
//     _gn_relu_bwd (XLA in the JAX package): gn_relu_bwd_bf16, with
//     xhat = (x - mean) * inv and gy = dy * [forward pre-activation > 0],
//       dt_c = sum_{n, vox} gy,  ds_c = sum_{n, vox} gy * xhat,
//       per (n, g): P = sum_{c in g, vox} gy * s_c,  Q = sum gy * s_c * xhat,
//       dx = bf16(inv * (gy * s_c - (P + xhat * Q) / count));
//   - the XLA reduction multimodal_pl_tpu/ops/bd.py:439 bd_gn_fold: the
//     per-sample rows a, b that fold GroupNorm into the prologue of every
//     fused conv3x3_gn launch (gn_fold_bf16);
//   - both of the above on a slab of an H-split sample (spatial
//     parallelism): the slab's moments (gn_moments_bf16), exchanged between
//     the ranks by the caller, then the normalize or the fold rows from the
//     merged statistics (gn_apply_bf16); and the backward on such a slab in
//     two calls around the caller's sum over the ranks: the slab's
//     per-(sample, channel) sums of gy and gy * xhat (gn_bwd_sums_bf16),
//     then dx from the whole sample's sums and the slab's own ds and dt
//     (gn_bwd_dx_bf16).
//
// Statistics (forward and fold): each thread accumulates, for its 8
// channels over its rows, sums of x - k and (x - k)^2 with k its first value
// of the channel (a shift within a few standard deviations of the mean, so
// the sums do not cancel), turns them into (count, mean, M2), and moments
// are merged in a fixed order (merge_moments: Chan's formula over all sets
// at once): threads of a block, then blocks, then the channels of a group.
// That is the two-pass f32 formula up to summation order: the one-pass
// E[x^2] - mean^2 would cancel when |mean| >> std. No float atomics: every
// result is the same bits on every run.
//
// What bounds them on the H100: a few FLOP per byte, far below the card's
// ~295 FLOP/byte ridge, so device-memory bandwidth: the least traffic is one
// read of x and one write of y (forward), one read of x and dy and one write
// of dx (backward). Two routes, chosen by the wrapper from the shape:
//   - cluster (one launch): where a sample fits in the shared memory of a
//     thread-block cluster (up to 16 blocks of ~200 KB), its blocks copy
//     their rows of x (and dy) into shared memory once, merge their partial
//     statistics across the cluster through distributed shared memory in
//     rank order, and compute the output from shared memory: the one-read
//     bound. The forward clusters one sample; the backward clusters all B
//     samples, so that its rank 0 also sums ds and dt over the samples;
//   - grid (two launches): a statistics (or sums) launch whose blocks each
//     write their partials, then an elementwise launch whose blocks each
//     merge their sample's partials themselves, in the same fixed order
//     (a few KB from L2; this replaces a third, one-block-per-sample
//     moments launch), and stream their rows. Rows per block adapt so that
//     about 4 blocks run per SM (the wrapper's plan). The second read of x
//     hits L2 where the tensor fits its 50 MB.
// A persistent cooperative launch with a grid barrier would save the second
// launch but not the second read where x exceeds L2, and it holds every SM
// through the barrier; the two launches keep the grid free to fill the card.
//
// Layout: a thread owns one 16-byte vector of 8 channels; a block reads rpi =
// NT / V consecutive rows per iteration (V = C / 8 vectors per row), so a
// warp reads neighbouring vectors of a row, then of the next rows: coalesced
// 16-byte loads along C, and each thread keeps its 8 channels' parameters in
// registers. C must be a multiple of 8 and at most 2048. All offsets are
// 64-bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;        // threads per block
constexpr int MAX_C = 2048;    // NT vectors of 8 channels
constexpr int NT_ROWS = 1024;  // threads of the fold's rows kernel
constexpr int MAX_CLUSTER = 16;
constexpr int RED_FLOATS = 2 * NT * 8;  // per-thread partials of a block
constexpr int STATS_CLUSTER = 8;        // blocks whose statistics merge on chip

struct Moments {
  float n, mean, m2;  // count, mean, sum of squared deviations from the mean
};

// Merges m sets of moments get(0..m-1) in index order: the mean as the first
// set's mean plus the count-weighted mean of the others' offsets from it
// (small numbers, so no cancellation), then M2 = sum(m2_i + n_i * (mean_i -
// mean)^2) (Chan's pairwise formula, summed over all sets at once).
template <class Get>
__device__ __forceinline__ Moments merge_moments(int m, Get get) {
  const float ref = m > 0 ? get(0).mean : 0.0f;
  float n = 0.0f, off = 0.0f;
#pragma unroll 4
  for (int i = 0; i < m; ++i) {
    const Moments g = get(i);
    n += g.n;
    off += g.n * (g.mean - ref);
  }
  const float mean = n > 0.0f ? ref + off / n : 0.0f;
  float m2 = 0.0f;
#pragma unroll 4
  for (int i = 0; i < m; ++i) {  // a second read of the sets: cached
    const Moments g = get(i);
    const float d = g.mean - mean;
    m2 += g.m2 + g.n * d * d;
  }
  return {n, mean, m2};
}

__device__ __forceinline__ long long rows_end(long long r0, long long rows, long long S) {
  return r0 + rows < S ? r0 + rows : S;
}

// Rows of block i of rows_per_block rows (the last fewer, past S none).
__device__ __forceinline__ float block_count(long long i, long long rows_per_block, long long S) {
  const long long r0 = i * rows_per_block;
  const long long r1 = rows_end(r0, rows_per_block, S);
  return r1 > r0 ? float(r1 - r0) : 0.0f;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Rows that each row-thread of a block with n rows visits, stride rpi:
// row-thread i takes full + (i < rem) of them (no division per lookup).
struct RowCount {
  int full, rem;
  __device__ RowCount(long long n, int rpi) : full(int(n / rpi)), rem(int(n % rpi)) {}
  __device__ __forceinline__ float operator()(int i) const { return float(full + (i < rem)); }
};

struct Sums {
  float a, b;
};

// Adds m pairs get(0..m-1) in index order.
template <class Get>
__device__ __forceinline__ Sums add_sums(int m, Get get) {
  Sums t{0.0f, 0.0f};
#pragma unroll 4
  for (int i = 0; i < m; ++i) {
    const Sums g = get(i);
    t.a += g.a;
    t.b += g.b;
  }
  return t;
}

// Merges, per channel c < C, m sets get(c, i) with merge(count, get) in a
// fixed order, by a block of NTHR threads: with C <= NTHR, thread (c, k)
// merges sets [k * chunk, (k + 1) * chunk) (K = NTHR / C chunks) into
// scratch (NTHR of T), then thread c merges the K chunks in order; beyond
// NTHR channels one thread merges all. put(c, merged). Ends synchronized.
template <int NTHR, class T, class Merge, class Get, class Put>
__device__ __forceinline__ void merge_sets(int C, int m, T* scratch, Merge merge, Get get,
                                           Put put) {
  if (C <= NTHR) {
    const int K = NTHR / C;
    const int chunk = (m + K - 1) / K;
    const int c = threadIdx.x % C;
    const int k = threadIdx.x / C;
    if (k < K) {
      const int i0 = k * chunk < m ? k * chunk : m;
      const int i1 = (k + 1) * chunk < m ? (k + 1) * chunk : m;
      scratch[k * C + c] = merge(i1 - i0, [&](int i) { return get(c, i0 + i); });
    }
    __syncthreads();
    if (threadIdx.x < C)
      put(int(threadIdx.x), merge(K, [&](int j) { return scratch[j * C + threadIdx.x]; }));
  } else {
    for (int c = threadIdx.x; c < C; c += NTHR) put(c, merge(m, [&](int i) { return get(c, i); }));
  }
  __syncthreads();
}

struct MergeMoments {
  template <class Get>
  __device__ __forceinline__ Moments operator()(int m, Get get) const {
    return merge_moments(m, get);
  }
};

struct AddSums {
  template <class Get>
  __device__ __forceinline__ Sums operator()(int m, Get get) const {
    return add_sums(m, get);
  }
};

// Per-channel (mean, M2) of rows [r0, r1) of a (rows, C) bf16 matrix x in
// global or shared memory, into mean[c], m2[c] (global or shared). red:
// RED_FLOATS and mred: NT Moments of shared scratch. Called by the whole
// block; ends synchronized.
__device__ void block_moments(const __nv_bfloat16* x, long long r0, long long r1, int C,
                              float* red, Moments* mred, float* mean, float* m2) {
  const int V = C / 8;
  const int rpi = NT / V;
  const int v = threadIdx.x % V;
  const int r = threadIdx.x / V;
  const RowCount count(r1 > r0 ? r1 - r0 : 0, rpi);
  if (r < rpi) {
    float k[8], s[8], q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = s[j] = q[j] = 0.0f;
    const __nv_bfloat16* base = x + v * 8;
    if (r0 + r < r1) {
      const uint4 val = *reinterpret_cast<const uint4*>(base + (r0 + r) * C);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) k[j] = __bfloat162float(e[j]);
    }
    auto add = [&](const uint4& val) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __bfloat162float(e[j]) - k[j];
        s[j] += d;
        q[j] += d * d;
      }
    };
    long long row = r0 + r;
    for (; row + 3 * rpi < r1; row += 4 * rpi) {  // 4 loads in flight
      uint4 val[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        val[u] = *reinterpret_cast<const uint4*>(base + (row + u * rpi) * C);
#pragma unroll
      for (int u = 0; u < 4; ++u) add(val[u]);
    }
    for (; row < r1; row += rpi) add(*reinterpret_cast<const uint4*>(base + row * C));
    const float n = count(r);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ds = n > 0.0f ? s[j] / n : 0.0f;
      red[r * C + v * 8 + j] = k[j] + ds;
      red[NT * 8 + r * C + v * 8 + j] = fmaxf(q[j] - s[j] * ds, 0.0f);
    }
  }
  __syncthreads();
  merge_sets<NT>(
      C, rpi, mred, MergeMoments(),
      [&](int c, int i) { return Moments{count(i), red[i * C + c], red[NT * 8 + i * C + c]}; },
      [&](int c, const Moments& m) {
        mean[c] = m.mean;
        m2[c] = m.m2;
      });
}

// Per-channel moments of one sample from the partials p[i][2][C] (mean, M2)
// of its nblk blocks of rows_per_block rows (the last fewer), merged in
// merge_sets's fixed order into mean[c], m2[c] (shared); red: NTHR Moments
// of shared scratch. Ends synchronized.
template <int NTHR>
__device__ void merge_blocks(const float* p, long long S, int C, int nblk,
                             long long rows_per_block, Moments* red, float* mean, float* m2) {
  merge_sets<NTHR>(
      C, nblk, red, MergeMoments(),
      [&](int c, int i) {
        return Moments{block_count(i, rows_per_block, S), p[(long long)i * 2 * C + c],
                       p[(long long)i * 2 * C + C + c]};
      },
      [&](int c, const Moments& m) {
        mean[c] = m.mean;
        m2[c] = m.m2;
      });
}

// Fixed-order sums of one sample's per-block partials p[i][2][C] into a[c],
// b[c] (shared), in merge_sets's order. red: NTHR Sums of shared scratch.
template <int NTHR>
__device__ void sum_blocks(const float* p, int C, int nblk, Sums* red, float* a, float* b) {
  merge_sets<NTHR>(
      C, nblk, red, AddSums(),
      [&](int c, int i) {
        return Sums{p[(long long)i * 2 * C + c], p[(long long)i * 2 * C + C + c]};
      },
      [&](int c, const Sums& t) {
        a[c] = t.a;
        b[c] = t.b;
      });
}

// mean[c], m2[c] hold each channel's moments over S rows: merges the
// channels of each group in order and replaces them by the group's mean and
// inv = rsqrt(M2 / count + eps), per channel; writes (mean, inv) per group
// to stats[2][groups] unless stats is null. Ends synchronized.
__device__ void group_rows(float* mean, float* m2, long long S, int C, int groups, float eps,
                           float* stats) {
  const int cpg = C / groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const Moments m = merge_moments(cpg, [&](int j) {
      return Moments{float(S), mean[g * cpg + j], m2[g * cpg + j]};
    });
    const float inv = rsqrtf(__fadd_rn(m.m2 / m.n, eps));
    for (int j = 0; j < cpg; ++j) {
      mean[g * cpg + j] = m.mean;
      m2[g * cpg + j] = inv;
    }
    if (stats != nullptr) {
      stats[g] = m.mean;
      stats[groups + g] = inv;
    }
  }
  __syncthreads();
}

// A thread's 8 channels: group mean and inv, bf16-rounded scale and bias.
struct Chan {
  float mean[8], inv[8], s[8], t[8];
};

// The affine (issued early: its loads overlap the statistics' merge).
__device__ __forceinline__ void load_affine(Chan& p, const float* scale, const float* bias,
                                            int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p.s[j] = bf16_round(scale[c0 + j]);
    p.t[j] = bf16_round(bias[c0 + j]);
  }
}

// Mean and inv from per-channel rows in shared memory.
__device__ __forceinline__ void load_rows(Chan& p, const float* mean, const float* inv, int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p.mean[j] = mean[c0 + j];
    p.inv[j] = inv[c0 + j];
  }
}

// From per-group stats[2][groups] (the forward's mean, inv).
__device__ __forceinline__ void load_chan_stats(Chan& p, const float* stats, const float* scale,
                                                const float* bias, int c0, int cpg, int groups) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int g = (c0 + j) / cpg;
    p.mean[j] = stats[g];
    p.inv[j] = stats[groups + g];
    p.s[j] = bf16_round(scale[c0 + j]);
    p.t[j] = bf16_round(bias[c0 + j]);
  }
}

// The forward's normalized value and pre-activation, rounded op by op.
__device__ __forceinline__ float xhat_of(float x, const Chan& p, int j) {
  return __fmul_rn(__fsub_rn(x, p.mean[j]), p.inv[j]);
}
__device__ __forceinline__ float pre_of(float xhat, const Chan& p, int j) {
  return __fadd_rn(__fmul_rn(xhat, p.s[j]), p.t[j]);
}

__device__ __forceinline__ uint4 norm_relu_vec(uint4 val, const Chan& p) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    e[j] = __float2bfloat16_rn(fmaxf(pre_of(xhat_of(__bfloat162float(e[j]), p, j), p, j), 0.0f));
  return val;
}

// y rows [r0, r1) of one sample (x, y point at the sample's row 0; x may be
// shared memory), row-thread layout, 4 vectors in flight per thread.
__device__ void norm_relu_rows(const __nv_bfloat16* x, __nv_bfloat16* y, long long r0, long long r1,
                               int C, const Chan& p) {
  const int V = C / 8;
  const int rpi = NT / V;
  const int v = threadIdx.x % V;
  const int r = threadIdx.x / V;
  if (r >= rpi) return;
  long long row = r0 + r;
  for (; row + 3 * rpi < r1; row += 4 * rpi) {
    uint4 val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      val[u] = *reinterpret_cast<const uint4*>(x + (row + u * rpi) * C + v * 8);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<uint4*>(y + (row + u * rpi) * C + v * 8) = norm_relu_vec(val[u], p);
  }
  for (; row < r1; row += rpi) {
    const uint4 val = *reinterpret_cast<const uint4*>(x + row * C + v * 8);
    *reinterpret_cast<uint4*>(y + row * C + v * 8) = norm_relu_vec(val, p);
  }
}

// Copies rows [r0, r1) of a sample (global) into a shared tile, 4 vectors in
// flight per thread.
__device__ void load_tile(const __nv_bfloat16* x, __nv_bfloat16* tile, long long r0, long long r1,
                          int C) {
  const long long nvec = (r1 - r0) * (C / 8);
  const uint4* src = reinterpret_cast<const uint4*>(x + r0 * C);
  uint4* dst = reinterpret_cast<uint4*>(tile);
  long long i = threadIdx.x;
  for (; i + 3 * NT < nvec; i += 4 * NT) {
    uint4 val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) val[u] = src[i + u * NT];
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[i + u * NT] = val[u];
  }
  for (; i < nvec; i += NT) dst[i] = src[i];
}

// ---- GroupNorm -> ReLU forward ------------------------------------------

// Per block of rows_per_block rows of sample blockIdx.y, per-channel (mean,
// M2); the blocks of a cluster merge theirs through distributed shared
// memory in rank order, and rank 0 writes the cluster's moments to
// partial[b][cluster][2][C]: fewer partials for the next launch to merge.
__device__ __forceinline__ void stats_block(const __nv_bfloat16* x, float* partial, long long S,
                                            int C, long long rows_per_block) {
  __shared__ float red[RED_FLOATS];
  __shared__ Moments mred[NT];
  __shared__ float part[2][MAX_C];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = int(cluster.num_blocks());
  const int b = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  block_moments(x + (long long)b * S * C, r0, rows_end(r0, rows_per_block, S), C, red, mred,
                part[0], part[1]);
  cluster.sync();
  if (cluster.block_rank() == 0) {
    float* p = partial + (((long long)b * (gridDim.x / q) + blockIdx.x / q) * 2) * C;
    for (int c = threadIdx.x; c < C; c += NT) {
      const Moments m = merge_moments(q, [&](int j) {
        const float* pj = cluster.map_shared_rank(&part[0][0], j);
        return Moments{block_count(blockIdx.x + j, rows_per_block, S), pj[c], pj[MAX_C + c]};
      });
      p[c] = m.mean;
      p[C + c] = m.m2;
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its moments
}

// Grid route, launch 1.
__global__ void __launch_bounds__(NT)
gn_relu_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ partial,
                     long long S, int C, long long rows_per_block) {
  stats_block(x, partial, S, C, rows_per_block);
}

// Grid route, launch 2: each block merges its sample's stats_nblk partials
// (fixed order), forms the groups' mean and inv, and normalizes its rows;
// block 0 of each sample writes stats[b][2][groups].
__global__ void __launch_bounds__(NT)
gn_relu_norm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ partial,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ stats, long long S, int C,
                    int groups, float eps, int stats_nblk, long long stats_rows,
                    long long norm_rows) {
  __shared__ Moments red[NT];
  __shared__ float rows[2][MAX_C];
  const int b = blockIdx.y;
  const int c0 = (threadIdx.x % (C / 8)) * 8;
  Chan p;
  load_affine(p, scale, bias, c0);
  merge_blocks<NT>(partial + (long long)b * stats_nblk * 2 * C, S, C, stats_nblk, stats_rows, red,
                   rows[0], rows[1]);
  group_rows(rows[0], rows[1], S, C, groups, eps,
             blockIdx.x == 0 ? stats + (long long)b * 2 * groups : nullptr);
  load_rows(p, rows[0], rows[1], c0);
  const long long r0 = (long long)blockIdx.x * norm_rows;
  norm_relu_rows(x + (long long)b * S * C, out + (long long)b * S * C, r0,
                 rows_end(r0, norm_rows, S), C, p);
}

// Cluster route: one launch, grid (m, B), a cluster of m blocks per sample.
// Dynamic shared memory: the block's rows of x, RED_FLOATS of scratch, its
// (mean, M2) per channel, the sample's per-channel rows (mean, inv).
__global__ void __launch_bounds__(NT)
gn_relu_cluster_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ stats, long long S, int C, int groups, float eps,
                       long long rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int m = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int b = blockIdx.y;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + rows_per_block * C * 2);
  Moments* mred = reinterpret_cast<Moments*>(red + RED_FLOATS);
  float* part = reinterpret_cast<float*>(mred + NT);  // this block's (mean, M2) per channel
  float* rows = part + 2 * C;  // the sample's (mean, M2), then (mean, inv)
  const long long r0 = (long long)rank * rows_per_block;
  const long long r1 = rows_end(r0, rows_per_block, S);
  const long long n = r1 > r0 ? r1 - r0 : 0;
  const __nv_bfloat16* xs = x + (long long)b * S * C;
  const int c0 = (threadIdx.x % (C / 8)) * 8;
  Chan p;
  load_affine(p, scale, bias, c0);
  load_tile(xs, tile, r0, r0 + n, C);
  __syncthreads();
  block_moments(tile, 0, n, C, red, mred, part, part + C);
  cluster.sync();  // every block's partials are written
  for (int c = threadIdx.x; c < C; c += NT) {
    const Moments mm = merge_moments(m, [&](int j) {  // rank order
      const float* pj = cluster.map_shared_rank(part, j);
      return Moments{block_count(j, rows_per_block, S), pj[c], pj[C + c]};
    });
    rows[c] = mm.mean;
    rows[C + c] = mm.m2;
  }
  cluster.sync();  // no block leaves while another still reads its partials
  group_rows(rows, rows + C, S, C, groups, eps,
             rank == 0 ? stats + (long long)b * 2 * groups : nullptr);
  load_rows(p, rows, rows + C, c0);
  norm_relu_rows(tile, out + ((long long)b * S + r0) * C, 0, n, C, p);
}

// ---- GroupNorm -> ReLU backward -----------------------------------------

// Per row-thread sums of gy and gy * xhat over rows [r0, r1) of one sample
// (x, dy at the sample's row 0, global or shared), merged over the block's
// row-threads in order into a[c], b[c] (global or shared). Ends synchronized.
__device__ void block_sums(const __nv_bfloat16* x, const __nv_bfloat16* dy, long long r0,
                           long long r1, int C, const Chan& p, float* red, Sums* sred, float* a,
                           float* b) {
  const int V = C / 8;
  const int rpi = NT / V;
  const int v = threadIdx.x % V;
  const int r = threadIdx.x / V;
  if (r < rpi) {
    float sa[8], sb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) sa[j] = sb[j] = 0.0f;
    auto add = [&](const uint4& xv, const uint4& gv) {
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xh = xhat_of(__bfloat162float(xe[j]), p, j);
        const float gy = pre_of(xh, p, j) > 0.0f ? __bfloat162float(ge[j]) : 0.0f;
        sa[j] += gy;
        sb[j] += gy * xh;
      }
    };
    long long row = r0 + r;
    for (; row + 3 * rpi < r1; row += 4 * rpi) {  // 8 loads in flight
      uint4 xv[4], gv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xv[u] = *reinterpret_cast<const uint4*>(x + (row + u * rpi) * C + v * 8);
        gv[u] = *reinterpret_cast<const uint4*>(dy + (row + u * rpi) * C + v * 8);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) add(xv[u], gv[u]);
    }
    for (; row < r1; row += rpi)
      add(*reinterpret_cast<const uint4*>(x + row * C + v * 8),
          *reinterpret_cast<const uint4*>(dy + row * C + v * 8));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[r * C + v * 8 + j] = sa[j];
      red[NT * 8 + r * C + v * 8 + j] = sb[j];
    }
  }
  __syncthreads();
  merge_sets<NT>(
      C, rpi, sred, AddSums(),
      [&](int c, int i) { return Sums{red[i * C + c], red[NT * 8 + i * C + c]}; },
      [&](int c, const Sums& t) {
        a[c] = t.a;
        b[c] = t.b;
      });
}

// a[c] = sum gy, b[c] = sum gy * xhat of one sample: replaced by the group's
// P / count and Q / count, per channel. Ends synchronized.
__device__ void group_pq(float* a, float* b, const float* scale, int C, int groups,
                         float inv_count) {
  const int cpg = C / groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float P = 0.0f, Q = 0.0f;
    for (int j = 0; j < cpg; ++j) {
      const float s = bf16_round(scale[g * cpg + j]);
      P += s * a[g * cpg + j];
      Q += s * b[g * cpg + j];
    }
    for (int j = 0; j < cpg; ++j) {
      a[g * cpg + j] = P * inv_count;
      b[g * cpg + j] = Q * inv_count;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ uint4 dx_vec(uint4 xv, uint4 gv, const Chan& p, const float* pn,
                                        const float* qn) {
  const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xv);
  const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
  uint4 out;
  __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float xh = xhat_of(__bfloat162float(xe[j]), p, j);
    const float gy = pre_of(xh, p, j) > 0.0f ? __bfloat162float(ge[j]) : 0.0f;
    oe[j] = __float2bfloat16_rn(p.inv[j] * (gy * p.s[j] - pn[j] - xh * qn[j]));
  }
  return out;
}

// dx rows [r0, r1) of one sample; pq: the sample's per-channel P / count
// and Q / count (shared).
__device__ void dx_rows(const __nv_bfloat16* x, const __nv_bfloat16* dy, __nv_bfloat16* dx,
                        long long r0, long long r1, int C, const Chan& p, const float* pn_c,
                        const float* qn_c) {
  const int V = C / 8;
  const int rpi = NT / V;
  const int v = threadIdx.x % V;
  const int r = threadIdx.x / V;
  if (r >= rpi) return;
  float pn[8], qn[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pn[j] = pn_c[v * 8 + j];
    qn[j] = qn_c[v * 8 + j];
  }
  long long row = r0 + r;
  for (; row + 3 * rpi < r1; row += 4 * rpi) {  // 8 loads in flight
    uint4 xv[4], gv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = *reinterpret_cast<const uint4*>(x + (row + u * rpi) * C + v * 8);
      gv[u] = *reinterpret_cast<const uint4*>(dy + (row + u * rpi) * C + v * 8);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      *reinterpret_cast<uint4*>(dx + (row + u * rpi) * C + v * 8) = dx_vec(xv[u], gv[u], p, pn, qn);
  }
  for (; row < r1; row += rpi) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + row * C + v * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(dy + row * C + v * 8);
    *reinterpret_cast<uint4*>(dx + row * C + v * 8) = dx_vec(xv, gv, p, pn, qn);
  }
}

// Grid route, launch 1: gn_bwd_sums_kernel<false, false> (below) with the
// forward's (mean, inv), the clusters' partials into
// partial[b][cluster][2][C].

// Grid route, launch 2, grid (dx_nblk, B + 1): blocks of row B - 1 and
// below merge their sample's partials (fixed order), form P and Q per group
// and write their rows of dx; block (0, B) sums ds and dt over the samples in
// order into dsdt[2][C] (ds, dt).
__global__ void __launch_bounds__(NT, 3)
gn_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                 const float* __restrict__ stats, const float* __restrict__ scale,
                 const float* __restrict__ bias, const float* __restrict__ partial,
                 __nv_bfloat16* __restrict__ dx, float* __restrict__ dsdt, long long S, int C,
                 int groups, int B, int nblk, long long block_rows) {
  __shared__ Sums red[NT];
  __shared__ float tot[2][MAX_C];
  const int b = blockIdx.y;
  if (b == B) {
    if (blockIdx.x != 0) return;
    __shared__ float acc[2][MAX_C];
    for (int c = threadIdx.x; c < C; c += NT) acc[0][c] = acc[1][c] = 0.0f;
    for (int bb = 0; bb < B; ++bb) {
      sum_blocks<NT>(partial + (long long)bb * nblk * 2 * C, C, nblk, red, tot[0], tot[1]);
      for (int c = threadIdx.x; c < C; c += NT) {
        acc[0][c] += tot[1][c];  // ds: sum gy * xhat
        acc[1][c] += tot[0][c];  // dt: sum gy
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < C; c += NT) {
      dsdt[c] = acc[0][c];
      dsdt[C + c] = acc[1][c];
    }
    return;
  }
  sum_blocks<NT>(partial + (long long)b * nblk * 2 * C, C, nblk, red, tot[0], tot[1]);
  group_pq(tot[0], tot[1], scale, C, groups, 1.0f / float(S * (C / groups)));
  Chan p;
  load_chan_stats(p, stats + (long long)b * 2 * groups, scale, bias,
                  (threadIdx.x % (C / 8)) * 8, C / groups, groups);
  const long long r0 = (long long)blockIdx.x * block_rows;
  const long long off = (long long)b * S * C;
  dx_rows(x + off, dy + off, dx + off, r0, rows_end(r0, block_rows, S), C, p, tot[0], tot[1]);
}

// Cluster route: one launch, grid (m * B), one cluster over all B samples,
// m blocks per sample. Dynamic shared memory: the block's rows of x and of
// dy, RED_FLOATS of scratch, its (sum gy, sum gy * xhat) per channel, the
// sample's per-channel P / count and Q / count.
__global__ void __launch_bounds__(NT)
gn_bwd_cluster_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                      const float* __restrict__ stats, const float* __restrict__ scale,
                      const float* __restrict__ bias, __nv_bfloat16* __restrict__ dx,
                      float* __restrict__ dsdt, long long S, int C, int groups, int m,
                      long long rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = int(cluster.num_blocks()) / m;  // samples
  const int rank = int(cluster.block_rank());
  const int b = rank / m;
  const long long tile_elems = rows_per_block * C;
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gt = xt + tile_elems;
  float* red = reinterpret_cast<float*>(gt + tile_elems);
  Sums* sred = reinterpret_cast<Sums*>(red + RED_FLOATS);
  float* part = reinterpret_cast<float*>(sred + NT);  // this block's sums per channel
  float* tot = part + 2 * C;  // the sample's sums, then P / count, Q / count
  const long long r0 = (long long)(rank % m) * rows_per_block;
  const long long r1 = rows_end(r0, rows_per_block, S);
  const long long n = r1 > r0 ? r1 - r0 : 0;
  const long long off = (long long)b * S * C;
  load_tile(x + off, xt, r0, r0 + n, C);
  load_tile(dy + off, gt, r0, r0 + n, C);
  Chan p;
  load_chan_stats(p, stats + (long long)b * 2 * groups, scale, bias,
                  (threadIdx.x % (C / 8)) * 8, C / groups, groups);
  __syncthreads();
  block_sums(xt, gt, 0, n, C, p, red, sred, part, part + C);
  cluster.sync();  // every block's sums are written
  for (int c = threadIdx.x; c < C; c += NT) {
    float ta = 0.0f, tb = 0.0f;
    for (int j = 0; j < m; ++j) {  // rank order
      const float* pj = cluster.map_shared_rank(part, b * m + j);
      ta += pj[c];
      tb += pj[C + c];
    }
    tot[c] = ta;
    tot[C + c] = tb;
    if (rank == 0) {
      float ds = 0.0f, dt = 0.0f;
      for (int bb = 0; bb < nb; ++bb) {
        float sa = 0.0f, sb = 0.0f;
        for (int j = 0; j < m; ++j) {
          const float* pj = cluster.map_shared_rank(part, bb * m + j);
          sa += pj[c];
          sb += pj[C + c];
        }
        dt += sa;
        ds += sb;
      }
      dsdt[c] = ds;
      dsdt[C + c] = dt;
    }
  }
  cluster.sync();  // no block leaves while another still reads its sums
  group_pq(tot, tot + C, scale, C, groups, 1.0f / float(S * (C / groups)));
  dx_rows(xt, gt, dx + off + r0 * C, 0, n, C, p, tot, tot + C);
}

// ---- GroupNorm fold ------------------------------------------------------

// The fold's launch 1 (a kernel of its own name, for the profile).
__global__ void __launch_bounds__(NT)
gn_fold_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ partial,
                     long long S, int C, long long rows_per_block) {
  stats_block(x, partial, S, C, rows_per_block);
}

// The fold's launch 2, one block of NT_ROWS threads per sample: merges the blocks' moments per
// channel, then the channels of each group, in a fixed order, and writes
// a = inv * scale, b = bias - mean * a as rows[2][B][C]: the two-pass f32
// formula of bd_gn_fold and ops/norm.py::group_norm_fold up to summation
// order.
__global__ void __launch_bounds__(NT_ROWS)
gn_fold_rows_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ rows, long long S,
                    int C, int nblk, long long rows_per_block, int groups, float eps) {
  __shared__ Moments red[NT_ROWS];
  __shared__ float tot[2][MAX_C];
  const int b = blockIdx.x;
  merge_blocks<NT_ROWS>(partial + (long long)b * nblk * 2 * C, S, C, nblk, rows_per_block, red,
                        tot[0], tot[1]);
  group_rows(tot[0], tot[1], S, C, groups, eps, nullptr);
  const long long row = (long long)b * C;
  const long long rows_b = (long long)gridDim.x * C;
  for (int c = threadIdx.x; c < C; c += NT_ROWS) {
    const float a = __fmul_rn(tot[1][c], scale[c]);
    rows[row + c] = a;
    rows[rows_b + row + c] = __fsub_rn(bias[c], __fmul_rn(tot[0][c], a));
  }
}

// ---- Slab statistics, and GroupNorm from given statistics ------------------
//
// Spatial parallelism splits each sample's voxels (the H axis) over N ranks.
// Each rank computes its slab's per-(sample, group) moments
// (gn_moments_bf16), the ranks exchange them, and each rank normalizes or
// folds its slab from the merged statistics (gn_apply_bf16, which merges the
// N sets in rank order in its prologue). These are the two pallas_calls of
// fused_group_norm_relu with a collective between them.

// Slab moments, launch 1 (a kernel of its own name, for the profile).
__global__ void __launch_bounds__(NT)
gn_slab_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ partial,
                     long long S, int C, long long rows_per_block) {
  stats_block(x, partial, S, C, rows_per_block);
}

// Slab moments, launch 2, one block of NT_ROWS threads per sample: the
// blocks' per-channel moments merged as gn_fold_rows_kernel merges them,
// then the channels of each group (count S each) as group_rows does; writes
// (mean, M2) per group to moments[b][2][groups].
__global__ void __launch_bounds__(NT_ROWS)
gn_slab_moments_kernel(const float* __restrict__ partial, float* __restrict__ moments,
                       long long S, int C, int nblk, long long rows_per_block, int groups) {
  __shared__ Moments red[NT_ROWS];
  __shared__ float tot[2][MAX_C];
  const int b = blockIdx.x;
  merge_blocks<NT_ROWS>(partial + (long long)b * nblk * 2 * C, S, C, nblk, rows_per_block, red,
                        tot[0], tot[1]);
  const int cpg = C / groups;
  float* out = moments + (long long)b * 2 * groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const Moments m = merge_moments(cpg, [&](int j) {
      return Moments{float(S), tot[0][g * cpg + j], tot[1][g * cpg + j]};
    });
    out[g] = m.mean;
    out[groups + g] = m.m2;
  }
}

// Per-group mean and inv of sample b into st[g], st[MAX_C + g] (shared).
// nslab > 0: merges the slabs' (mean, M2) sets moments[i][b][2][groups], i <
// nslab, each of count S * C / groups, in rank order (merge_moments), and
// forms inv = rsqrt(M2 / count + eps) as group_rows does. nslab == 0:
// moments[b][2][groups] already holds (mean, inv). Ends synchronized.
__device__ void slab_group_stats(const float* moments, int nslab, int B, int b, long long S,
                                 int C, int groups, float eps, float* st) {
  const float n = float(S * (C / groups));
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    if (nslab == 0) {
      st[g] = moments[(long long)b * 2 * groups + g];
      st[MAX_C + g] = moments[(long long)b * 2 * groups + groups + g];
      continue;
    }
    const Moments m = merge_moments(nslab, [&](int i) {
      const float* p = moments + ((long long)i * B + b) * 2 * groups;
      return Moments{n, p[g], p[groups + g]};
    });
    st[g] = m.mean;
    st[MAX_C + g] = rsqrtf(__fadd_rn(m.m2 / m.n, eps));
  }
  __syncthreads();
}

// relu(GroupNorm) of rows from the given statistics, grid (norm_nblk, B):
// the grid route's normalize blocks, rounded as gn_relu_norm_kernel rounds.
__global__ void __launch_bounds__(NT)
gn_apply_relu_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ moments,
                     int nslab, const float* __restrict__ scale, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, long long S, int C, int groups, float eps,
                     long long norm_rows) {
  __shared__ float st[2][MAX_C];
  const int b = blockIdx.y;
  const int c0 = (threadIdx.x % (C / 8)) * 8;
  Chan p;
  load_affine(p, scale, bias, c0);
  slab_group_stats(moments, nslab, gridDim.y, b, S, C, groups, eps, &st[0][0]);
  const int cpg = C / groups;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    p.mean[j] = st[0][(c0 + j) / cpg];
    p.inv[j] = st[1][(c0 + j) / cpg];
  }
  const long long r0 = (long long)blockIdx.x * norm_rows;
  norm_relu_rows(x + (long long)b * S * C, out + (long long)b * S * C, r0,
                 rows_end(r0, norm_rows, S), C, p);
}

// GroupNorm fold rows from the given statistics, one block per sample:
// rows[2][B][C] = (a, b), rounded as gn_fold_rows_kernel rounds them.
__global__ void __launch_bounds__(NT)
gn_apply_fold_kernel(const float* __restrict__ moments, int nslab,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float* __restrict__ rows, long long S, int C, int groups, float eps) {
  __shared__ float st[2][MAX_C];
  const int b = blockIdx.x;
  slab_group_stats(moments, nslab, gridDim.x, b, S, C, groups, eps, &st[0][0]);
  const int cpg = C / groups;
  const long long row = (long long)b * C;
  const long long rows_b = (long long)gridDim.x * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    const float a = __fmul_rn(st[1][c / cpg], scale[c]);
    rows[row + c] = a;
    rows[rows_b + row + c] = __fsub_rn(bias[c], __fmul_rn(st[0][c / cpg], a));
  }
}

// ---- GroupNorm -> ReLU backward on a slab ----------------------------------
//
// The backward's only cross-slab quantities are the per-(sample, channel)
// sums of gy and gy * xhat over the whole sample (P and Q of each group are
// formed from them). gn_bwd_sums_bf16 writes the slab's; the caller sums
// them over the ranks; gn_bwd_dx_bf16 forms P and Q from the sums of the
// whole sample and writes dx, and ds, dt from the slab's own sums (the
// slab's part of the parameter gradients, which the caller sums with the
// others).
//
// gn_bwd_sums_bf16 merges the slabs' moments in each sums block's prologue
// (gn_apply_bf16's merge; a few KB from L2), so no launch precedes it.
// Where one cluster holds all of a sample's blocks, its rank 0 adds the
// blocks' sums and writes the final ones: one launch. Else every cluster's
// rank 0 writes its partial and a second launch adds the partials per
// sample. Either way the additions run in gn_relu_bwd_bf16's grid-route
// order (blocks in clusters of STATS_CLUSTER, then the clusters), so a whole
// sample's sums are that route's bits.

// The sums launch of both routes. Grid (nblk rounded up to the cluster, B),
// clusters of q blocks. Block (i, b) takes the group statistics of sample
// b: SLAB, from slab_group_stats (nslab > 0: the slabs' (mean, M2) merged;
// nslab == 0: (mean, inv) copied), block (0, b) writing them to
// stats[b][2][groups]; else moments is the forward's (B, 2, groups) (mean,
// inv), read from global memory (through the shared buffer that the sums
// reuse, ptxas spills 56 bytes instead of 20 and the train step's GroupNorm
// backward runs 2% slower), and stats is unused. The block sums gy and gy * xhat over its rows_per_block
// rows; rank 0 of each cluster adds its blocks' sums in rank order. FINAL:
// one cluster per sample, whose sum is the sample's, into out[b][2][C]. Else
// into out[b][cluster][2][C], partials for gn_bwd_dx_kernel or
// gn_bwd_slab_merge_kernel.
template <bool SLAB, bool FINAL>
__global__ void __launch_bounds__(NT, 3)
gn_bwd_sums_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ moments, int nslab, const float* __restrict__ scale,
                   const float* __restrict__ bias, float* __restrict__ stats,
                   float* __restrict__ out, long long S, int C, int groups, float eps,
                   long long rows_per_block) {
  __shared__ float red[RED_FLOATS];
  __shared__ Sums sred[NT];
  __shared__ float part[2][MAX_C];  // first the groups' (mean, inv), then the block's sums
  cg::cluster_group cluster = cg::this_cluster();
  const int q = int(cluster.num_blocks());
  const int b = blockIdx.y;
  Chan p;
  const int c0 = (threadIdx.x % (C / 8)) * 8, cpg = C / groups;
  if constexpr (SLAB) {
    slab_group_stats(moments, nslab, gridDim.y, b, S, C, groups, eps, &part[0][0]);
    if (blockIdx.x == 0)
      for (int g = threadIdx.x; g < groups; g += NT) {
        stats[(long long)b * 2 * groups + g] = part[0][g];
        stats[(long long)b * 2 * groups + groups + g] = part[1][g];
      }
    load_affine(p, scale, bias, c0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p.mean[j] = part[0][(c0 + j) / cpg];
      p.inv[j] = part[1][(c0 + j) / cpg];
    }
    __syncthreads();  // every thread holds its statistics before part is reused
  } else {
    load_chan_stats(p, moments + (long long)b * 2 * groups, scale, bias, c0, cpg, groups);
  }
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  block_sums(x + (long long)b * S * C, dy + (long long)b * S * C, r0,
             rows_end(r0, rows_per_block, S), C, p, red, sred, part[0], part[1]);
  cluster.sync();
  if (cluster.block_rank() == 0) {
    float* dst = FINAL ? out + (long long)b * 2 * C
                       : out + (((long long)b * (gridDim.x / q) + blockIdx.x / q) * 2) * C;
    for (int c = threadIdx.x; c < C; c += NT) {
      const Sums t = add_sums(q, [&](int j) {
        const float* pj = cluster.map_shared_rank(&part[0][0], j);
        return Sums{pj[c], pj[MAX_C + c]};
      });
      dst[c] = t.a;
      dst[C + c] = t.b;
    }
  }
  cluster.sync();  // no block leaves while rank 0 still reads its sums
}

// The second launch where the clusters are several: one block per sample,
// its clusters' partials partial[b][i][2][C] summed in sum_blocks's order
// into sums[b][2][C] = (sum gy, sum gy * xhat).
__global__ void __launch_bounds__(NT)
gn_bwd_slab_merge_kernel(const float* __restrict__ partial, float* __restrict__ sums, int C,
                         int nblk) {
  __shared__ Sums red[NT];
  __shared__ float tot[2][MAX_C];
  const int b = blockIdx.x;
  sum_blocks<NT>(partial + (long long)b * nblk * 2 * C, C, nblk, red, tot[0], tot[1]);
  for (int c = threadIdx.x; c < C; c += NT) {
    sums[((long long)b * 2) * C + c] = tot[0][c];
    sums[((long long)b * 2 + 1) * C + c] = tot[1][c];
  }
}

// Grid (dx_nblk, B + 1): blocks of row B - 1 and below read their sample's
// whole-sample sums (sums[b][2][C]), form P and Q per group over `count`
// values and write their rows of dx; block (0, B) sums the slab's own sums
// (slab_sums[b][2][C]) over the samples in order into dsdt[2][C] (ds, dt).
__global__ void __launch_bounds__(NT, 3)
gn_bwd_slab_dx_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                      const float* __restrict__ stats, const float* __restrict__ scale,
                      const float* __restrict__ bias, const float* __restrict__ slab_sums,
                      const float* __restrict__ sums, __nv_bfloat16* __restrict__ dx,
                      float* __restrict__ dsdt, long long S, int C, int groups, int B,
                      float inv_count, long long block_rows) {
  __shared__ float tot[2][MAX_C];
  const int b = blockIdx.y;
  if (b == B) {
    if (blockIdx.x != 0) return;
    for (int c = threadIdx.x; c < C; c += NT) {
      float ds = 0.0f, dt = 0.0f;
      for (int bb = 0; bb < B; ++bb) {
        dt += slab_sums[((long long)bb * 2) * C + c];
        ds += slab_sums[((long long)bb * 2 + 1) * C + c];
      }
      dsdt[c] = ds;
      dsdt[C + c] = dt;
    }
    return;
  }
  for (int c = threadIdx.x; c < C; c += NT) {
    tot[0][c] = sums[((long long)b * 2) * C + c];
    tot[1][c] = sums[((long long)b * 2 + 1) * C + c];
  }
  __syncthreads();
  group_pq(tot[0], tot[1], scale, C, groups, inv_count);
  Chan p;
  load_chan_stats(p, stats + (long long)b * 2 * groups, scale, bias,
                  (threadIdx.x % (C / 8)) * 8, C / groups, groups);
  const long long r0 = (long long)blockIdx.x * block_rows;
  const long long off = (long long)b * S * C;
  dx_rows(x + off, dy + off, dx + off, r0, rows_end(r0, block_rows, S), C, p, tot[0], tot[1]);
}

bool bad_shape(int B, long long S, int C, int groups) {
  return B < 1 || B > 65535 || S < 1 || C < 8 || C > MAX_C || C % 8 != 0 || groups < 1 ||
         C % groups != 0;
}

bool bad_grid(long long S, long long rows_per_block, int nblk) {
  return rows_per_block < 1 || nblk < 1 || (long long)nblk * rows_per_block < S;
}

// Statistics blocks rounded up to whole clusters of STATS_CLUSTER; the
// clusters' partials, of STATS_CLUSTER * rows_per_block rows each, are what
// the second launch merges.
int stats_blocks(int nblk) {
  return (nblk + STATS_CLUSTER - 1) / STATS_CLUSTER * STATS_CLUSTER;
}

// Dynamic shared memory of the cluster kernels beyond their tiles.
constexpr long long FWD_SCRATCH = 4LL * RED_FLOATS + NT * (long long)sizeof(Moments);
constexpr long long BWD_SCRATCH = 4LL * RED_FLOATS + NT * (long long)sizeof(Sums);

int smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// Allows the cluster kernels the card's whole shared memory and clusters of
// up to MAX_CLUSTER blocks (once per process).
int set_cluster_attributes() {
  static int err = -1;
  if (err < 0) {
    const int smem = smem_optin();
    err = int(cudaFuncSetAttribute(gn_relu_cluster_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (!err)
      err = int(cudaFuncSetAttribute(gn_bwd_cluster_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    if (!err)
      err = int(cudaFuncSetAttribute(gn_relu_cluster_kernel,
                                     cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    if (!err)
      err = int(cudaFuncSetAttribute(gn_bwd_cluster_kernel,
                                     cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
  }
  return err;
}

template <class... KArgs, class... Args>
int launch_cluster(void (*kernel)(KArgs...), dim3 grid, int cluster, size_t smem,
                   cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(&cfg, kernel, args...));
}

}  // namespace

extern "C" {

// The largest cluster (blocks) that the card schedules with the whole
// shared memory per block, that shared memory in bytes, and how many
// clusters of STATS_CLUSTER blocks of each statistics kernel (GroupNorm ->
// ReLU forward, backward, fold) the card holds at once. Returns a
// cudaError_t as int.
int gn_relu_limits(int* max_cluster, int* smem_bytes, int* stats_clusters) {
  int err = set_cluster_attributes();
  if (err) return err;
  {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(STATS_CLUSTER, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = STATS_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = int(cudaOccupancyMaxActiveClusters(&stats_clusters[0], gn_relu_stats_kernel, &cfg));
    if (!err)
      err = int(cudaOccupancyMaxActiveClusters(&stats_clusters[1],
                                               gn_bwd_sums_kernel<false, false>, &cfg));
    if (!err)
      err = int(cudaOccupancyMaxActiveClusters(&stats_clusters[2], gn_fold_stats_kernel, &cfg));
    if (err) return err;
  }
  *smem_bytes = smem_optin();
  *max_cluster = 0;
  for (int m = MAX_CLUSTER; m >= 1 && *max_cluster == 0; m /= 2) {
    int fwd = 0, bwd = 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(m, 1, 1);
    cfg.blockDim = dim3(NT, 1, 1);
    cfg.dynamicSmemBytes = *smem_bytes;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = m;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&fwd, gn_relu_cluster_kernel, &cfg) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&bwd, gn_bwd_cluster_kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();  // clear: a refused size only means a smaller cluster
      continue;
    }
    if (fwd > 0 && bwd > 0) *max_cluster = m;
  }
  return 0;
}

// relu(GroupNorm(x)) of a contiguous (B, S, C) bf16 x into out (like x),
// scale and bias (C) f32, and the per-(sample, group) mean and inv into
// stats (B, 2, groups) f32. cluster > 0: the cluster route, cluster blocks
// of `rows` rows per sample (cluster * rows >= S), dynamic shared memory
// `smem` bytes. cluster == 0: the grid route, statistics blocks of `rows`
// rows (nblk of them, workspace f32 B * nblk * 2 * C; launched in clusters of
// STATS_CLUSTER), normalize blocks of norm_rows rows (norm_nblk). Returns a
// cudaError_t as int: 0 when every launch was accepted.
int gn_relu_fwd_bf16(const void* x, const void* scale, const void* bias, void* out, void* stats,
                     void* workspace, int B, long long S, int C, int groups, float eps,
                     int cluster, long long rows, int nblk, long long norm_rows, int norm_nblk,
                     long long smem, void* stream) {
  if (bad_shape(B, S, C, groups)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(out);
  float* stb = static_cast<float*>(stats);
  if (cluster > 0) {
    if (cluster > MAX_CLUSTER || bad_grid(S, rows, cluster) ||
        smem < rows * C * 2 + FWD_SCRATCH + 16LL * C)
      return int(cudaErrorInvalidValue);
    int err = set_cluster_attributes();
    if (err) return err;
    return launch_cluster(gn_relu_cluster_kernel, dim3(cluster, B, 1), cluster, size_t(smem), st,
                          xb, sc, bi, yb, stb, S, C, groups, eps, rows);
  }
  if (bad_grid(S, rows, nblk) || bad_grid(S, norm_rows, norm_nblk))
    return int(cudaErrorInvalidValue);
  float* partial = static_cast<float*>(workspace);
  const int grid = stats_blocks(nblk);
  const int err = launch_cluster(gn_relu_stats_kernel, dim3(grid, B, 1), STATS_CLUSTER, 0, st, xb,
                                 partial, S, C, rows);
  if (err) return err;
  gn_relu_norm_kernel<<<dim3(norm_nblk, B), NT, 0, st>>>(
      xb, partial, sc, bi, yb, stb, S, C, groups, eps, grid / STATS_CLUSTER, rows * STATS_CLUSTER,
      norm_rows);
  return int(cudaGetLastError());
}

// The backward of gn_relu_fwd_bf16 for a contiguous (B, S, C) bf16 x and
// incoming gradient dy, with the forward's stats (B, 2, groups): dx (like x)
// and dsdt (2, C) f32 = (d scale, d bias). cluster > 0: the cluster route,
// one cluster of cluster * B blocks, `cluster` blocks of `rows` rows per
// sample, `smem` bytes of dynamic shared memory. cluster == 0: the grid
// route, sums blocks of `rows` rows (nblk; workspace f32 B * nblk * 2 * C;
// clusters of STATS_CLUSTER), dx blocks of dx_block_rows rows (dx_nblk).
// Returns a cudaError_t as int.
int gn_relu_bwd_bf16(const void* x, const void* dy, const void* scale, const void* bias,
                     const void* stats, void* dx, void* dsdt, void* workspace, int B, long long S,
                     int C, int groups, int cluster, long long rows, int nblk,
                     long long dx_block_rows, int dx_nblk, long long smem, void* stream) {
  if (bad_shape(B, S, C, groups)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(dy);
  const float* stb = static_cast<const float*>(stats);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  __nv_bfloat16* dxb = static_cast<__nv_bfloat16*>(dx);
  float* dsdtb = static_cast<float*>(dsdt);
  if (cluster > 0) {
    if ((long long)cluster * B > MAX_CLUSTER || bad_grid(S, rows, cluster) ||
        smem < rows * C * 4 + BWD_SCRATCH + 16LL * C)
      return int(cudaErrorInvalidValue);
    int err = set_cluster_attributes();
    if (err) return err;
    return launch_cluster(gn_bwd_cluster_kernel, dim3(cluster * B, 1, 1), cluster * B,
                          size_t(smem), st, xb, gb, stb, sc, bi, dxb, dsdtb, S, C, groups,
                          cluster, rows);
  }
  if (bad_grid(S, rows, nblk) || bad_grid(S, dx_block_rows, dx_nblk))
    return int(cudaErrorInvalidValue);
  float* partial = static_cast<float*>(workspace);
  const int grid = stats_blocks(nblk);
  const int err = launch_cluster(gn_bwd_sums_kernel<false, false>, dim3(grid, B, 1),
                                 STATS_CLUSTER, 0, st, xb, gb, stb, 0, sc, bi,
                                 static_cast<float*>(nullptr), partial, S, C, groups, 0.0f, rows);
  if (err) return err;
  gn_bwd_dx_kernel<<<dim3(dx_nblk, B + 1), NT, 0, st>>>(xb, gb, stb, sc, bi, partial, dxb, dsdtb,
                                                         S, C, groups, B, grid / STATS_CLUSTER,
                                                         dx_block_rows);
  return int(cudaGetLastError());
}

// GroupNorm fold rows of a contiguous (B, S, C) bf16 x with scale and bias
// (C) f32: rows (2, B, C) f32 = (a, b) with GroupNorm(x) == x * a + b, from
// one read of x (statistics blocks in clusters of STATS_CLUSTER). workspace:
// f32, B * stats_nblk * 2 * C elements. Returns a
// cudaError_t as int: 0 when both launches were accepted.
int gn_fold_bf16(const void* x, const void* scale, const void* bias, void* rows,
                 void* workspace, int B, long long S, int C, int groups, float eps,
                 long long stats_rows, int stats_nblk, void* stream) {
  if (bad_shape(B, S, C, groups) || bad_grid(S, stats_rows, stats_nblk))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(workspace);
  const int grid = stats_blocks(stats_nblk);
  const int err = launch_cluster(gn_fold_stats_kernel, dim3(grid, B, 1), STATS_CLUSTER, 0, st,
                                 static_cast<const __nv_bfloat16*>(x), partial, S, C, stats_rows);
  if (err) return err;
  gn_fold_rows_kernel<<<B, NT_ROWS, 0, st>>>(partial, static_cast<const float*>(scale),
                                             static_cast<const float*>(bias),
                                             static_cast<float*>(rows), S, C,
                                             grid / STATS_CLUSTER, stats_rows * STATS_CLUSTER,
                                             groups, eps);
  return int(cudaGetLastError());
}

// Per-(sample, group) moments of a contiguous (B, S, C) bf16 slab x into
// moments (B, 2, groups) f32 = (mean, M2), from one read of x (statistics
// blocks of stats_rows rows, stats_nblk of them, in clusters of
// STATS_CLUSTER; workspace f32 B * stats_nblk * 2 * C). Returns a
// cudaError_t as int: 0 when both launches were accepted.
int gn_moments_bf16(const void* x, void* moments, void* workspace, int B, long long S, int C,
                    int groups, long long stats_rows, int stats_nblk, void* stream) {
  if (bad_shape(B, S, C, groups) || bad_grid(S, stats_rows, stats_nblk))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(workspace);
  const int grid = stats_blocks(stats_nblk);
  const int err = launch_cluster(gn_slab_stats_kernel, dim3(grid, B, 1), STATS_CLUSTER, 0, st,
                                 static_cast<const __nv_bfloat16*>(x), partial, S, C, stats_rows);
  if (err) return err;
  gn_slab_moments_kernel<<<B, NT_ROWS, 0, st>>>(partial, static_cast<float*>(moments), S, C,
                                                grid / STATS_CLUSTER, stats_rows * STATS_CLUSTER,
                                                groups);
  return int(cudaGetLastError());
}

// GroupNorm of a contiguous (B, S, C) bf16 slab from given statistics:
// with nslab > 0, moments (nslab, B, 2, groups) f32 holds each slab's (mean,
// M2) of count S * C / groups, merged in rank order; with nslab == 0,
// moments (B, 2, groups) holds (mean, inv). out (like x, unless null):
// relu(((x - mean) * inv) * s + t), normalize blocks of norm_rows rows
// (norm_nblk of them), as gn_relu_fwd_bf16 computes it. rows (2, B, C) f32
// (unless null): the fold rows (a, b) of gn_fold_bf16. Returns a cudaError_t
// as int.
int gn_apply_bf16(const void* x, const void* moments, int nslab, const void* scale,
                  const void* bias, void* out, void* rows, int B, long long S, int C, int groups,
                  float eps, long long norm_rows, int norm_nblk, void* stream) {
  if (bad_shape(B, S, C, groups) || nslab < 0 || (out == nullptr && rows == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mo = static_cast<const float*>(moments);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (out != nullptr) {
    if (x == nullptr || bad_grid(S, norm_rows, norm_nblk)) return int(cudaErrorInvalidValue);
    gn_apply_relu_kernel<<<dim3(norm_nblk, B), NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), mo, nslab, sc, bi,
        static_cast<__nv_bfloat16*>(out), S, C, groups, eps, norm_rows);
    const int err = int(cudaGetLastError());
    if (err) return err;
  }
  if (rows != nullptr) {
    gn_apply_fold_kernel<<<B, NT, 0, st>>>(mo, nslab, sc, bi, static_cast<float*>(rows), S, C,
                                           groups, eps);
  }
  return int(cudaGetLastError());
}

// The backward of the slab normalize of gn_apply_bf16, part 1: for a
// contiguous (B, S, C) bf16 slab x and incoming gradient dy, with the slabs'
// moments (nslab > 0: (nslab, B, 2, groups) (mean, M2) merged in rank order;
// nslab == 0: (B, 2, groups) (mean, inv)), writes stats (B, 2, groups) f32
// = the (mean, inv) it used, and sums (B, 2, C) f32 = this slab's (sum gy,
// sum gy * xhat) per sample and channel, from sums blocks of `rows` rows
// (nblk of them). cluster == STATS_CLUSTER: one launch, one cluster per
// sample, nblk <= STATS_CLUSTER; workspace unused. cluster == 0: two
// launches, the blocks in clusters of STATS_CLUSTER writing partials to
// workspace (f32 B * nblk * 2 * C), then their merge. Returns a cudaError_t
// as int.
int gn_bwd_sums_bf16(const void* x, const void* dy, const void* moments, int nslab,
                     const void* scale, const void* bias, void* stats, void* sums,
                     void* workspace, int B, long long S, int C, int groups, float eps,
                     long long rows, int nblk, int cluster, void* stream) {
  if (bad_shape(B, S, C, groups) || nslab < 0 || bad_grid(S, rows, nblk))
    return int(cudaErrorInvalidValue);
  if (cluster != 0 && (cluster != STATS_CLUSTER || nblk > cluster))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(dy);
  const float* mo = static_cast<const float*>(moments);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* stb = static_cast<float*>(stats);
  if (cluster > 0) {
    return launch_cluster(gn_bwd_sums_kernel<true, true>, dim3(cluster, B, 1), cluster, 0, st, xb,
                          gb, mo, nslab, sc, bi, stb, static_cast<float*>(sums), S, C, groups, eps,
                          rows);
  }
  if (workspace == nullptr) return int(cudaErrorInvalidValue);
  float* partial = static_cast<float*>(workspace);
  const int grid = stats_blocks(nblk);
  const int err = launch_cluster(gn_bwd_sums_kernel<true, false>, dim3(grid, B, 1), STATS_CLUSTER,
                                 0, st, xb, gb, mo, nslab, sc, bi, stb, partial, S, C, groups, eps,
                                 rows);
  if (err) return err;
  gn_bwd_slab_merge_kernel<<<B, NT, 0, st>>>(partial, static_cast<float*>(sums), C,
                                             grid / STATS_CLUSTER);
  return int(cudaGetLastError());
}

// Part 2: dx (like x) from the whole sample's sums (B, 2, C) f32 over
// `count` values per group (the whole sample's voxels times the channels of
// a group), with the stats that part 1 wrote; dsdt (2, C) f32 = this slab's
// (d scale, d bias) from its own sums slab_sums (part 1's). dx blocks of
// dx_block_rows rows (dx_nblk). One launch. Returns a cudaError_t as int.
int gn_bwd_dx_bf16(const void* x, const void* dy, const void* stats, const void* scale,
                   const void* bias, const void* slab_sums, const void* sums, void* dx,
                   void* dsdt, int B, long long S, int C, int groups, long long count,
                   long long dx_block_rows, int dx_nblk, void* stream) {
  if (bad_shape(B, S, C, groups) || bad_grid(S, dx_block_rows, dx_nblk) || count < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gn_bwd_slab_dx_kernel<<<dim3(dx_nblk, B + 1), NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<const float*>(stats), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const float*>(slab_sums),
      static_cast<const float*>(sums), static_cast<__nv_bfloat16*>(dx),
      static_cast<float*>(dsdt), S, C, groups, B, 1.0f / float(count), dx_block_rows);
  return int(cudaGetLastError());
}

const char* gn_relu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
