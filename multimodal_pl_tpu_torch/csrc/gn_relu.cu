// GroupNorm -> ReLU for Hopper, as three launches over an NDHWC bf16 tensor.
//
// Replaces multimodal_pl_tpu/ops/pallas/fused_gn_relu.py::fused_group_norm_relu
// (its _stats_kernel and _norm_kernel): every GN -> ReLU pre-activation of the
// segmenter and the refiner under autograd.
//
// What it computes, for x viewed as (B, S, C) with S the voxels of a sample,
// in three launches on the caller's stream from one call, gn_relu_bf16:
//   1. gn_stats_kernel: per (sample, channel) f32 sum and sum of squares over S.
//      Each block sums a contiguous range of rows and writes its partials to
//      partial[b][block][2][C].
//   2. gn_moments_kernel: one block per sample reduces the partials over blocks
//      in a fixed order (no float atomics, so the result is deterministic),
//      pools channels into groups and forms the one-pass moments
//      mean = E[x], var = E[x^2] - mean^2, inv = rsqrt(var + 1e-5), written per
//      channel as moments[b][2][C].
//   3. gn_norm_relu_kernel: out = bf16(relu(((f32(x) - mean) * inv) * scale + bias))
//      with scale and bias rounded to bf16 first (the JAX model casts the
//      affine to the activations' dtype), rounded op by op (no FMA
//      contraction) in the order of the Pallas kernel's formula.
//
// Layout: a thread owns one 16-byte vector of 8 channels, so a warp reads
// neighbouring vectors of a row, then of the next rows: coalesced 16-byte
// loads along C. C must be a multiple of 8 and at most 2048.
//
// What bounds it on the H100: the statistics and normalize launches each read
// x once (the latter also writes the output) at a few FLOP per byte, far below
// the card's ~295 FLOP/byte ridge, so the bound is device-memory bandwidth.
// The moments launch reads only the (B, nblk, 2, C) partials; the per-channel
// rows of the normalize launch are staged in shared memory. All offsets are
// 64-bit.

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

const char* gn_relu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
