// GroupNorm for Hopper over an NDHWC bf16 tensor: GroupNorm -> ReLU
// (training), and the GroupNorm fold rows of the fused conv's prologue
// (inference).
//
// Replaces
//   - multimodal_pl_tpu/ops/pallas/fused_gn_relu.py::fused_group_norm_relu
//     (its _stats_kernel and _norm_kernel): every GN -> ReLU pre-activation of
//     the segmenter and the refiner under autograd (gn_relu_bf16);
//   - the XLA reduction multimodal_pl_tpu/ops/bd.py:439 bd_gn_fold: the
//     per-sample rows a, b that fold GroupNorm into the prologue of every
//     fused conv3x3_gn launch (gn_fold_bf16).
//
// gn_relu_bf16, for x viewed as (B, S, C) with S the voxels of a sample, in
// three launches on the caller's stream:
//   1. gn_stats_kernel: per (sample, channel) f32 sum and sum of squares over S.
//      Each block sums a contiguous range of rows and writes its partials to
//      partial[b][block][2][C].
//   2. gn_moments_kernel: one block per sample reduces the partials over blocks
//      in a fixed order (no float atomics, so the result is deterministic),
//      pools channels into groups and forms the one-pass moments
//      mean = E[x], var = E[x^2] - mean^2, inv = rsqrt(var + 1e-5) (the
//      Pallas kernel's formula), written per channel as moments[b][2][C].
//   3. gn_norm_relu_kernel: out = bf16(relu(((f32(x) - mean) * inv) * scale + bias))
//      with scale and bias rounded to bf16 first (the JAX model casts the
//      affine to the activations' dtype), rounded op by op (no FMA
//      contraction) in the order of the Pallas kernel's formula.
//
// gn_fold_bf16, in two launches that read x once:
//   1. gn_fold_stats_kernel: each thread accumulates, for its 8 channels over
//      its rows, sums of x - k and (x - k)^2 with k its first value of the
//      channel (a shift within a few standard deviations of the mean, so the
//      sums do not cancel), turns them into (count, mean, M2), and the block
//      merges its threads' moments in a fixed order (merge_moments: Chan's
//      formula over all sets at once) into partial[b][block][2][C] (mean, M2).
//   2. gn_fold_rows_kernel: one block per sample merges the blocks' moments
//      per channel, then the channels of each group, in a fixed order,
//      and writes var = M2 / count, inv = rsqrt(var + eps), a = inv * scale,
//      b = bias - mean * a as rows[2][B][C]: the two-pass f32 formula of
//      bd_gn_fold and ops/norm.py::group_norm_fold up to summation order. The
//      one-pass E[x^2] - mean^2 would cancel when |mean| >> std.
//
// Layout: a thread owns one 16-byte vector of 8 channels, so a warp reads
// neighbouring vectors of a row, then of the next rows: coalesced 16-byte
// loads along C. C must be a multiple of 8 and at most 2048.
//
// What bounds it on the H100: every pass over x reads it once (normalize
// also writes the output) at a few FLOP per byte, far below the card's ~295
// FLOP/byte ridge, so the bound is device-memory bandwidth: the fold reads x
// once, GN -> ReLU twice and writes once. The reduction launches read only
// the (B, nblk, 2, C) partials; per-channel rows are staged in shared
// memory. All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int MAX_C = 2048;  // NT vectors of 8 channels

__global__ void __launch_bounds__(NT)
gn_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ partial,
                long long S, int C, long long rows_per_block) {
  __shared__ float red[2][NT * 8];
  const int V = C / 8;       // vectors per row
  const int rpi = NT / V;    // rows per iteration of the block
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int v = threadIdx.x % V;
  const int r = threadIdx.x / V;
  float s[8], q[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.0f;
  const long long r0 = (long long)blk * rows_per_block;
  const long long r1 = r0 + rows_per_block < S ? r0 + rows_per_block : S;
  if (r < rpi) {
    for (long long row = r0 + r; row < r1; row += rpi) {
      const uint4 val = *reinterpret_cast<const uint4*>(
          x + ((long long)b * S + row) * C + v * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(e[j]);
        s[j] += f;
        q[j] += f * f;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[0][r * C + v * 8 + j] = s[j];
      red[1][r * C + v * 8 + j] = q[j];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float ts = 0.0f, tq = 0.0f;
    for (int i = 0; i < rpi; ++i) {  // fixed order over the row groups
      ts += red[0][i * C + c];
      tq += red[1][i * C + c];
    }
    float* p = partial + (((long long)b * nblk + blk) * 2) * C;
    p[c] = ts;
    p[C + c] = tq;
  }
}

// One block per sample. Thread t sums blocks [k * chunk, (k + 1) * chunk) of
// channel c = t % C for k = t / C (k < NT / C), then the K chunk sums are
// added in order; channels beyond NT take one thread each over all blocks.
__global__ void __launch_bounds__(NT)
gn_moments_kernel(const float* __restrict__ partial, float* __restrict__ moments,
                  int C, int nblk, int groups, float count) {
  __shared__ float red[2][NT];
  __shared__ float tot[2][MAX_C];
  const int b = blockIdx.x;
  const float* p = partial + (long long)b * nblk * 2 * C;
  if (C <= NT) {
    const int K = NT / C;
    const int c = threadIdx.x % C;
    const int k = threadIdx.x / C;
    if (k < K) {
      const int chunk = (nblk + K - 1) / K;
      const int i1 = (k + 1) * chunk < nblk ? (k + 1) * chunk : nblk;
      float s = 0.0f, q = 0.0f;
      for (int i = k * chunk; i < i1; ++i) {
        s += p[(long long)i * 2 * C + c];
        q += p[(long long)i * 2 * C + C + c];
      }
      red[0][k * C + c] = s;
      red[1][k * C + c] = q;
    }
    __syncthreads();
    if (threadIdx.x < C) {
      float s = 0.0f, q = 0.0f;
      for (int j = 0; j < K; ++j) {
        s += red[0][j * C + threadIdx.x];
        q += red[1][j * C + threadIdx.x];
      }
      tot[0][threadIdx.x] = s;
      tot[1][threadIdx.x] = q;
    }
  } else {
    for (int c = threadIdx.x; c < C; c += NT) {
      float s = 0.0f, q = 0.0f;
      for (int i = 0; i < nblk; ++i) {
        s += p[(long long)i * 2 * C + c];
        q += p[(long long)i * 2 * C + C + c];
      }
      tot[0][c] = s;
      tot[1][c] = q;
    }
  }
  __syncthreads();
  const int cpg = C / groups;
  float* m = moments + (long long)b * 2 * C;
  for (int g = threadIdx.x; g < groups; g += NT) {
    float s = 0.0f, q = 0.0f;
    for (int j = 0; j < cpg; ++j) {
      s += tot[0][g * cpg + j];
      q += tot[1][g * cpg + j];
    }
    const float mean = __fdiv_rn(s, count);
    const float var = __fsub_rn(__fdiv_rn(q, count), __fmul_rn(mean, mean));
    const float inv = rsqrtf(__fadd_rn(var, 1e-5f));
    for (int j = 0; j < cpg; ++j) {
      m[g * cpg + j] = mean;
      m[C + g * cpg + j] = inv;
    }
  }
}

__global__ void __launch_bounds__(NT)
gn_norm_relu_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ moments,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, long long S, int C,
                    long long rows_per_block) {
  __shared__ float rows[4][MAX_C];
  const int b = blockIdx.y;
  for (int c = threadIdx.x; c < C; c += NT) {
    rows[0][c] = moments[(long long)b * 2 * C + c];
    rows[1][c] = moments[(long long)b * 2 * C + C + c];
    rows[2][c] = __bfloat162float(__float2bfloat16_rn(scale[c]));
    rows[3][c] = __bfloat162float(__float2bfloat16_rn(bias[c]));
  }
  __syncthreads();
  const int V = C / 8;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < S ? r0 + rows_per_block : S;
  const long long nvec = (r1 - r0) * V;
  const long long base = ((long long)b * S + r0) * C;
  for (long long i = threadIdx.x; i < nvec; i += NT) {
    const int c = int(i % V) * 8;
    const long long off = base + i * 8;  // rows are C = 8 * V elements long
    uint4 val = *reinterpret_cast<const uint4*>(x + off);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float f = __fsub_rn(__bfloat162float(e[j]), rows[0][c + j]);
      f = __fmul_rn(__fmul_rn(f, rows[1][c + j]), rows[2][c + j]);
      f = __fadd_rn(f, rows[3][c + j]);
      e[j] = __float2bfloat16_rn(fmaxf(f, 0.0f));
    }
    *reinterpret_cast<uint4*>(out + off) = val;
  }
}

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

// Rows that row-thread r of a block with rows [r0, r1) visits, stride rpi.
__device__ __forceinline__ float rows_of(long long r0, long long r1, int r, int rpi) {
  const long long first = r0 + r;
  return first < r1 ? float((r1 - first + rpi - 1) / rpi) : 0.0f;
}

__global__ void __launch_bounds__(NT)
gn_fold_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ partial,
                     long long S, int C, long long rows_per_block) {
  __shared__ float red[2][NT * 8];
  const int V = C / 8;       // vectors per row
  const int rpi = NT / V;    // rows per iteration of the block
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const int nblk = gridDim.x;
  const int v = threadIdx.x % V;
  const int r = threadIdx.x / V;
  const long long r0 = (long long)blk * rows_per_block;
  const long long r1 = r0 + rows_per_block < S ? r0 + rows_per_block : S;
  if (r < rpi) {
    float k[8], s[8], q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) k[j] = s[j] = q[j] = 0.0f;
    const __nv_bfloat16* base = x + (long long)b * S * C + v * 8;
    if (r0 + r < r1) {
      const uint4 val = *reinterpret_cast<const uint4*>(base + (r0 + r) * C);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) k[j] = __bfloat162float(e[j]);
    }
#pragma unroll 4
    for (long long row = r0 + r; row < r1; row += rpi) {
      const uint4 val = *reinterpret_cast<const uint4*>(base + row * C);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __bfloat162float(e[j]) - k[j];
        s[j] += d;
        q[j] += d * d;
      }
    }
    const float n = rows_of(r0, r1, r, rpi);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ds = n > 0.0f ? s[j] / n : 0.0f;
      red[0][r * C + v * 8 + j] = k[j] + ds;
      red[1][r * C + v * 8 + j] = fmaxf(q[j] - s[j] * ds, 0.0f);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    const Moments m = merge_moments(rpi, [&](int i) {  // fixed order over the row-threads
      return Moments{rows_of(r0, r1, i, rpi), red[0][i * C + c], red[1][i * C + c]};
    });
    float* p = partial + (((long long)b * nblk + blk) * 2) * C;
    p[c] = m.mean;
    p[C + c] = m.m2;
  }
}

// One block of NT_ROWS threads per sample. Thread t merges blocks
// [k * chunk, (k + 1) * chunk) of channel c = t % C for k = t / C
// (k < NT_ROWS / C), then the K chunk moments are merged in order; channels
// beyond NT_ROWS take one thread each over all blocks. Then each group
// merges its channels in order.
constexpr int NT_ROWS = 1024;

__global__ void __launch_bounds__(NT_ROWS)
gn_fold_rows_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                    const float* __restrict__ bias, float* __restrict__ rows, long long S,
                    int C, int nblk, long long rows_per_block, int groups, float eps) {
  __shared__ Moments red[NT_ROWS];
  __shared__ float tot[2][MAX_C];
  const int b = blockIdx.x;
  const float* p = partial + (long long)b * nblk * 2 * C;
  auto block = [&](int c, int i) {
    const long long r0 = (long long)i * rows_per_block;
    const long long r1 = r0 + rows_per_block < S ? r0 + rows_per_block : S;
    return Moments{float(r1 - r0), p[(long long)i * 2 * C + c], p[(long long)i * 2 * C + C + c]};
  };
  if (C <= NT_ROWS) {
    const int K = NT_ROWS / C;
    const int c = threadIdx.x % C;
    const int k = threadIdx.x / C;
    if (k < K) {
      const int chunk = (nblk + K - 1) / K;
      const int i0 = k * chunk < nblk ? k * chunk : nblk;
      const int i1 = (k + 1) * chunk < nblk ? (k + 1) * chunk : nblk;
      red[k * C + c] = merge_moments(i1 - i0, [&](int i) { return block(c, i0 + i); });
    }
    __syncthreads();
    if (threadIdx.x < C) {
      const Moments m = merge_moments(K, [&](int j) { return red[j * C + threadIdx.x]; });
      tot[0][threadIdx.x] = m.mean;
      tot[1][threadIdx.x] = m.m2;
    }
  } else {
    for (int c = threadIdx.x; c < C; c += NT_ROWS) {
      const Moments m = merge_moments(nblk, [&](int i) { return block(c, i); });
      tot[0][c] = m.mean;
      tot[1][c] = m.m2;
    }
  }
  __syncthreads();
  const int cpg = C / groups;
  const long long row = (long long)b * C;
  const long long rows_b = (long long)gridDim.x * C;
  for (int g = threadIdx.x; g < groups; g += NT_ROWS) {
    const Moments m = merge_moments(cpg, [&](int j) {
      return Moments{float(S), tot[0][g * cpg + j], tot[1][g * cpg + j]};
    });
    const float inv = rsqrtf(__fadd_rn(m.m2 / m.n, eps));
    for (int j = 0; j < cpg; ++j) {
      const int c = g * cpg + j;
      const float a = __fmul_rn(inv, scale[c]);
      rows[row + c] = a;
      rows[rows_b + row + c] = __fsub_rn(bias[c], __fmul_rn(m.mean, a));
    }
  }
}

bool bad_shape(int B, long long S, int C, long long rows_per_block, int nblk) {
  return B < 1 || B > 65535 || S < 1 || C < 8 || C > MAX_C || C % 8 != 0 ||
         rows_per_block < 1 || nblk < 1 || (long long)nblk * rows_per_block < S;
}

}  // namespace

extern "C" {

// relu(GroupNorm(x)) of a contiguous (B, S, C) bf16 x into out (like x), with
// scale and bias (C) f32. workspace: f32, B * (nblk_stats * 2 * C + 2 * C)
// elements, written in full. nblk * rows_per_block >= S for both launches.
// Returns a cudaError_t as int: 0 when all three launches were accepted.
int gn_relu_bf16(const void* x, const void* scale, const void* bias, void* out,
                 void* workspace, int B, long long S, int C, int groups,
                 long long stats_rows, int stats_nblk, long long norm_rows,
                 int norm_nblk, void* stream) {
  if (bad_shape(B, S, C, stats_rows, stats_nblk) || bad_shape(B, S, C, norm_rows, norm_nblk) ||
      groups < 1 || C % groups != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(workspace);
  float* moments = partial + (long long)B * stats_nblk * 2 * C;
  gn_stats_kernel<<<dim3(stats_nblk, B), NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), partial, S, C, stats_rows);
  int err = int(cudaGetLastError());
  if (err) return err;
  gn_moments_kernel<<<B, NT, 0, st>>>(partial, moments, C, stats_nblk, groups,
                                       float(S * (C / groups)));
  err = int(cudaGetLastError());
  if (err) return err;
  gn_norm_relu_kernel<<<dim3(norm_nblk, B), NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), moments, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), S, C, norm_rows);
  return int(cudaGetLastError());
}

// GroupNorm fold rows of a contiguous (B, S, C) bf16 x with scale and bias
// (C) f32: rows (2, B, C) f32 = (a, b) with GroupNorm(x) == x * a + b, from
// one read of x. workspace: f32, B * stats_nblk * 2 * C elements. Returns a
// cudaError_t as int: 0 when both launches were accepted.
int gn_fold_bf16(const void* x, const void* scale, const void* bias, void* rows,
                 void* workspace, int B, long long S, int C, int groups, float eps,
                 long long stats_rows, int stats_nblk, void* stream) {
  if (bad_shape(B, S, C, stats_rows, stats_nblk) || groups < 1 || C % groups != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(workspace);
  gn_fold_stats_kernel<<<dim3(stats_nblk, B), NT, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), partial, S, C, stats_rows);
  const int err = int(cudaGetLastError());
  if (err) return err;
  gn_fold_rows_kernel<<<B, NT_ROWS, 0, st>>>(partial, static_cast<const float*>(scale),
                                        static_cast<const float*>(bias),
                                        static_cast<float*>(rows), S, C, stats_nblk,
                                        stats_rows, groups, eps);
  return int(cudaGetLastError());
}

const char* gn_relu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
