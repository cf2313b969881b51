// Half-pixel-center trilinear upsampling of an NDHWC tensor by an integer
// factor f in {2, 4, 8} on every spatial axis, and its gradient, for Hopper.
//
// Replaces the XLA resize of the JAX package (no Pallas kernel there):
// multimodal_pl_tpu/ops/resize.py:21-31 resize_trilinear / upsample_trilinear
// (jax.image.resize, method 'trilinear'), called by the decoders'
// upsample + skip (models/unet3d.py, models/refiner.py) and by the deep_up
// resize of the attention maps (models/unet3d.py:206-211), and its gradient
// (XLA's transpose of that resize).
//
// The function is F.interpolate(mode='trilinear', align_corners=False) on
// each axis: output o reads source s = max((o + 0.5) / f - 0.5, 0) as
// (1 - l) * x[i0] + l * x[i1], i0 = floor(s), l = s - i0, i1 = min(i0 + 1,
// n - 1) (edge clamped). For f in {2, 4, 8} every s and l is exact in f32.
// The outputs with i0 = i form the segment [lo(i), hi(i)) (seg()): 3f/2
// outputs for i = 0 (its first f/2 clamped to s = 0), f inside, f/2 for
// i = n - 1 (both taps on the last input), all f for n = 1.
//
// What bounds both on the H100: a few FLOP per byte, so device-memory
// bandwidth; the output of the forward and the input of the backward are
// f^3 times the other tensor and dominate the bytes.
//
// resize3d_fwd_kernel: y = up_f(x) [+ skip]. A block takes one input plane
//   pair (d0, d1 = min(d0 + 1, D - 1)) of sample n, a group of the output
//   planes od of d0's segment, hs consecutive input rows h0 and a part of
//   each output row: every output row (od, oh) whose taps those rows hold.
//   Staged (the plan's choice without a skip): the block copies the source
//   rows h0 .. h0 + hs (clamped) of planes d0 and d1 into shared memory once
//   (cp.async, 16 bytes a copy, where the rows are 16-byte multiples) and
//   makes a shared table of the W taps (w0, lw per ow). Unstaged (with a
//   skip, where the skip's reads and the stores set the pace): the taps are
//   read through L1. A thread owns VEC consecutive elements (16 bytes) of
//   the flat output row of Wo * C elements, whatever C is, deriving (ow, c)
//   per element: it reads the 8 taps of its elements once, blends them over
//   W, and then, for each output row of its segments, blends over H and D
//   and stores 16 bytes. The skip is read the same way, one row ahead,
//   after the block has asked L2 for all of its skip rows. A row whose byte
//   length or pointers are not 16-byte aligned stores element by element,
//   masked at the row's end.
//   Summation: the 8 taps in F.interpolate's nesting, d over h over w,
//   ((1 - ld) * ((1 - lh) * W00 + lh * W01) + ld * ((1 - lh) * W10 +
//   lh * W11)) with Wdh = (1 - lw) * x[..w0] + lw * x[..w1], in f32; the
//   skip added in f32; one rounding to the output type. The W blends are
//   shared by the rows, so the sums are those of a per-element evaluation.
//
// resize3d_bwd_kernel: dx = up_f^T(dy), one launch, no scratch in device
//   memory. Every input element sums, in a fixed order, the output elements
//   that read it, so no atomics and the same bits on every run. A block owns
//   a tile of Th x Tw input (h, w) positions, all C, over the input planes
//   [d_lo, d_hi) of sample n. It streams the dy planes od that read the
//   tile, f * d_lo - f/2 .. f * d_hi + f/2 - 1 (clamped), in ascending
//   order; each plane's halo, the outputs [f * h_lo - f/2, f * h_hi + f/2)
//   x [f * w_lo - f/2, f * w_hi + f/2) (clamped), goes into shared memory
//   by cp.async into one of two buffers (the next plane loads while this
//   one is reduced). Each thread keeps one column (w, a 16-byte run of
//   channels) of the tile and walks its rows: the block reduces the plane
//   over W (each halo row, each input w: the 2f outputs o in [f*w - f/2,
//   f*w + 3f/2) with weight (1 - l(o)) [i0(o) = w] + l(o) [i1(o) = w],
//   ascending), then over H (the same rule) into f32, and adds the result
//   with the D weight into f32 accumulators in shared memory for planes
//   i0(od) and i1(od). A plane is rounded once to dx's type and written as
//   soon as i0(od) passes it: no later od reads it. Two planes of
//   accumulators suffice. Order per input element: over od ascending of
//   w_d * (over oh ascending of w_h * (over ow ascending of w_w * dy)). The
//   W and H sums run over all 2f taps without a branch: a tap of weight 0
//   (an output past the volume's edge) reads the edge output, which its
//   input reads anyway. Where D is split between blocks (a small grid), the
//   split falls on input planes: each block re-reads the f or so halo planes
//   it shares with its neighbour and never shares a sum.
//
// The launch plans (tile sizes, the d split, shared-memory bytes, grid) come
// from the caller (ops/resize.py); the entry points recompute the shared
// memory layout from them and refuse a plan they cannot take. All offsets
// into the tensors are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                   // threads per block
constexpr long long SMEM_MAX = 232448;    // shared memory a block may use (227 KB)
constexpr long long SMEM_DEFAULT = 49152; // above this a kernel needs the attribute
constexpr int RING = 2;     // backward: halo buffers (plane od + 1 loads while od is reduced)

long long g_launches = 0;  // kernel launches accepted, for the tests

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T moved as one aligned load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  const Pack<T, VEC> r = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f32(r.e[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  Pack<T, VEC> r;
#pragma unroll
  for (int k = 0; k < VEC; ++k) r.e[k] = from_f32<T>(v[k]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = r;
}

// f32 runs in shared memory: float4 pieces where CV allows (the run is then
// 16-byte aligned), else one float at a time.
template <int CV>
__device__ __forceinline__ void ld_f32(const float* p, float (&v)[CV]) {
  if constexpr (CV % 4 == 0) {
#pragma unroll
    for (int k = 0; k < CV; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      v[k] = q.x; v[k + 1] = q.y; v[k + 2] = q.z; v[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CV; ++k) v[k] = p[k];
  }
}

template <int CV>
__device__ __forceinline__ void st_f32(float* p, const float (&v)[CV]) {
  if constexpr (CV % 4 == 0) {
#pragma unroll
    for (int k = 0; k < CV; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < CV; ++k) p[k] = v[k];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Ask L2 for `bytes` (a multiple of 16) from the 16-byte aligned p.
__device__ __forceinline__ void prefetch_l2(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(bytes) : "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Source taps of output index o on an axis of n inputs at factor 1/inv_f:
// i0, i1 and the weight l of i1 (F.interpolate's align_corners=False rule).
__device__ __forceinline__ void taps(int o, int n, float inv_f, int& i0, int& i1, float& l) {
  float s = (float(o) + 0.5f) * inv_f - 0.5f;
  s = s < 0.0f ? 0.0f : s;
  i0 = int(s);
  l = s - float(i0);
  i1 = i0 < n - 1 ? i0 + 1 : i0;
}

// The weight with which output o reads input i (0 where it does not).
__device__ __forceinline__ float tap_weight(int o, int i, int n, float inv_f) {
  int i0, i1;
  float l;
  taps(o, n, inv_f, i0, i1, l);
  return (i0 == i ? 1.0f - l : 0.0f) + (i1 == i ? l : 0.0f);
}

// The outputs [lo, hi) whose first tap i0 is input i, of n inputs.
__device__ __forceinline__ void seg(int i, int n, int f, int& lo, int& hi) {
  lo = i == 0 ? 0 : f * i + f / 2;
  hi = i == n - 1 ? f * n : f * i + f + f / 2;
}

// The W taps of output column ow: from the block's table where it made one,
// else computed.
__device__ __forceinline__ void w_taps(const float2* wtab, int staged, int ow, int W, float inv_f,
                                       int& w0, int& w1, float& lw) {
  if (staged) {
    const float2 t = wtab[ow];
    w0 = __float_as_int(t.x);
    w1 = min(w0 + 1, W - 1);
    lw = t.y;
  } else {
    taps(ow, W, inv_f, w0, w1, lw);
  }
}

// Copy count contiguous elements into shared memory: 16-byte cp.async
// copies where vec (count * sizeof(T) is then a multiple of 16 and both ends
// are aligned), else one element at a time.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long count, bool vec) {
  if (vec) {
    const long long chunks = count * static_cast<long long>(sizeof(T)) / 16;
    for (long long i = threadIdx.x; i < chunks; i += NT)
      cp_async16(reinterpret_cast<char*>(dst) + i * 16, reinterpret_cast<const char*>(src) + i * 16);
  } else {
    for (long long i = threadIdx.x; i < count; i += NT) dst[i] = src[i];
  }
}

// y (N, D*f, H*f, W*f, C) = up_f(x (N, D, H, W, C)) [+ skip (like y)].
// VEC = 16 / sizeof(T) elements per thread and store; CH_VEC: C % VEC == 0,
// so a thread's elements share one ow and its shared-memory reads are
// 16 bytes; ST_VEC: the output rows (and y, skip) are 16-byte aligned. The
// block's part cp of csplit takes the chunks [cp, cp + 1) * nchunks / csplit
// of each output row.
template <typename T, int VEC, bool CH_VEC, bool ST_VEC>
__global__ void __launch_bounds__(NT, 3)
resize3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ skip, T* __restrict__ y,
                    int D, int H, int W, int C, int f, int hs, int dgroups, int csplit,
                    int hblocks, int staged, long long stage_elems, int src_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* st = reinterpret_cast<T*>(smem);  // [2][stage_elems]: planes d0, d1
  float2* wtab = reinterpret_cast<float2*>(smem + 2 * stage_elems * sizeof(T));  // [Wo]
  const float inv_f = 1.0f / float(f);
  const int Do = D * f, Ho = H * f, Wo = W * f;
  int b = blockIdx.x;  // the grid has fewer than 2^31 blocks: 32-bit division
  const int cp = b % csplit;
  b /= csplit;
  const int hb = b % hblocks;
  b /= hblocks;
  const int g = b % dgroups;
  b /= dgroups;
  const int d0 = b % D;
  const long long n = b / D;
  int lo_d, hi_d;
  seg(d0, D, f, lo_d, hi_d);
  const int od_lo = lo_d + g * (hi_d - lo_d) / dgroups;
  const int od_hi = lo_d + (g + 1) * (hi_d - lo_d) / dgroups;
  if (od_lo >= od_hi) return;
  const int j_lo = hb * hs, j_hi = min(H, j_lo + hs);
  const int nrows = min(j_hi, H - 1) - j_lo + 1;
  const int d1 = min(d0 + 1, D - 1);
  const long long wc = static_cast<long long>(W) * C;
  const int rowlen = Wo * C;
  const int nchunks = (rowlen + VEC - 1) / VEC;
  const int c_lo = cp * nchunks / csplit;  // csplit * nchunks < 2^31 (resize3d_fwd)
  const int c_n = (cp + 1) * nchunks / csplit - c_lo;
  if constexpr (ST_VEC) {
    // the skip this block reads, asked of L2 ahead of the rows that read it
    if (skip != nullptr) {
      const int oh0 = j_lo == 0 ? 0 : f * j_lo + f / 2;
      const int noh = (j_hi == H ? Ho : f * j_hi + f / 2) - oh0;
      for (int r = threadIdx.x; r < (od_hi - od_lo) * noh; r += NT)
        prefetch_l2(skip + ((n * Do + od_lo + r / noh) * Ho + oh0 + r % noh) * rowlen +
                        static_cast<long long>(c_lo) * VEC,
                    unsigned(c_n) * 16u);
    }
  }
  const int items = (j_hi - j_lo) * c_n;
  // the source rows: staged in shared memory, or (direct) read where they lie
  const T* src[2] = {x + ((n * D + d0) * H + j_lo) * wc, x + ((n * D + d1) * H + j_lo) * wc};
  if (staged) {
    stage(st, src[0], nrows * wc, src_vec);
    stage(st + stage_elems, src[1], nrows * wc, src_vec);
    cp_async_commit();
    for (int ow = threadIdx.x; ow < Wo; ow += NT) {
      int w0, w1;
      float lw;
      taps(ow, W, inv_f, w0, w1, lw);
      wtab[ow] = make_float2(__int_as_float(w0), lw);
    }
    cp_async_wait<0>();
    __syncthreads();
    src[0] = st;
    src[1] = st + stage_elems;
  }

  for (int it = threadIdx.x; it < items; it += NT) {
    const int jj = it / c_n;
    const int e = (c_lo + it - jj * c_n) * VEC;
    const int j = j_lo + jj;
    const T* rows[2][2];  // [d][h] staged source rows
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      rows[dd][0] = src[dd] + jj * wc;
      rows[dd][1] = src[dd] + (min(j + 1, H - 1) - j_lo) * wc;
    }
    float wb[2][2][VEC];  // the taps blended over W, per (d, h)
    if constexpr (CH_VEC) {
      const int ow = e / C, c = e - ow * C;
      int w0, w1;
      float lw;
      w_taps(wtab, staged, ow, W, inv_f, w0, w1, lw);
      const float ww0 = 1.0f - lw;
#pragma unroll
      for (int dd = 0; dd < 2; ++dd)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float a[VEC], a1[VEC];
          load_vec<T, VEC>(rows[dd][hh] + w0 * C + c, a);
          load_vec<T, VEC>(rows[dd][hh] + w1 * C + c, a1);
#pragma unroll
          for (int k = 0; k < VEC; ++k) wb[dd][hh][k] = ww0 * a[k] + lw * a1[k];
        }
    } else {
      int ow = e / C, c = e - ow * C;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (e + k < rowlen) {
          int w0, w1;
          float lw;
          w_taps(wtab, staged, ow, W, inv_f, w0, w1, lw);
          const float ww0 = 1.0f - lw;
#pragma unroll
          for (int dd = 0; dd < 2; ++dd)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              wb[dd][hh][k] = ww0 * to_f32(rows[dd][hh][w0 * C + c]) +
                              lw * to_f32(rows[dd][hh][w1 * C + c]);
        } else {
#pragma unroll
          for (int dd = 0; dd < 2; ++dd)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) wb[dd][hh][k] = 0.0f;
        }
        if (++c == C) {
          c = 0;
          ++ow;
        }
      }
    }
    // the output rows (od, oh) of this item in order, each row's skip
    // loaded one row ahead
    int lo_h, hi_h;
    seg(j, H, f, lo_h, hi_h);
    int od = od_lo, oh = lo_h;
    Pack<T, VEC> cur{};
    if constexpr (ST_VEC) {
      if (skip != nullptr)
        cur = *reinterpret_cast<const Pack<T, VEC>*>(skip + ((n * Do + od) * Ho + oh) * rowlen + e);
    }
    for (;;) {
      int od2 = od, oh2 = oh + 1;
      if (oh2 == hi_h) {
        oh2 = lo_h;
        ++od2;
      }
      const bool more = od2 < od_hi;
      Pack<T, VEC> next{};
      if constexpr (ST_VEC) {
        if (skip != nullptr && more)
          next = *reinterpret_cast<const Pack<T, VEC>*>(
              skip + ((n * Do + od2) * Ho + oh2) * rowlen + e);
      }
      int i0, i1;
      float ld, lh;
      taps(od, D, inv_f, i0, i1, ld);
      taps(oh, H, inv_f, i0, i1, lh);
      const float wd0 = 1.0f - ld, wh0 = 1.0f - lh;
      float out[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        out[k] = wd0 * (wh0 * wb[0][0][k] + lh * wb[0][1][k]) +
                 ld * (wh0 * wb[1][0][k] + lh * wb[1][1][k]);
      const long long o = ((n * Do + od) * Ho + oh) * rowlen + e;
      if constexpr (ST_VEC) {
        if (skip != nullptr) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) out[k] += to_f32(cur.e[k]);
        }
        store_vec<T, VEC>(y + o, out);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (e + k < rowlen) {
            float v = out[k];
            if (skip != nullptr) v += to_f32(skip[o + k]);
            y[o + k] = from_f32<T>(v);
          }
        }
      }
      if (!more) break;
      od = od2;
      oh = oh2;
      cur = next;
    }
  }
}

// n / d by a multiply for n * d < 2^32 (every item index of a block).
struct FastDiv {
  unsigned m;
  bool one;
};

__device__ __forceinline__ FastDiv fast_div(unsigned d) {
  return {d == 1 ? 0u : unsigned(0x100000000ULL / d + 1), d == 1};
}

__device__ __forceinline__ int operator/(int n, FastDiv d) {
  return d.one ? n : int(__umulhi(unsigned(n), d.m));
}

// dx (N, D, H, W, C) = up_f^T(dy (N, D*f, H*f, W*f, C)), one launch. CV
// channels per thread item: 16 bytes where C and the pointers allow, else 1;
// vload: elements per halo copy (16 bytes, or 1 where the rows are not
// 16-byte multiples).
template <typename T, int CV, int F>
__global__ void __launch_bounds__(NT)
resize3d_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int D, int H, int W, int C,
                    int Th, int Tw, int Dt, int hblocks, int wblocks, int dblocks, int pitch,
                    long long buf_elems, int tmp_off, int acc_off, int tab_off,
                    int vload) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);                       // [RING][n_oh][pitch]
  float* tmp = reinterpret_cast<float*>(smem + tmp_off);     // [n_oh][Tw][C]
  float* acc = reinterpret_cast<float*>(smem + acc_off);     // [2][Th][Tw][C]
  float* htab = reinterpret_cast<float*>(smem + tab_off);    // [Th][2F]
  float* wtab = htab + Th * 2 * F;                           // [Tw][2F]
  constexpr float inv_f = 1.0f / float(F);
  const int Do = D * F, Ho = H * F, Wo = W * F;
  const int rowlen = Wo * C;
  int b = blockIdx.x;  // the grid has fewer than 2^31 blocks: 32-bit division
  const int wb = b % wblocks;
  b /= wblocks;
  const int hb = b % hblocks;
  b /= hblocks;
  const int db = b % dblocks;
  const long long n = b / dblocks;
  const int h_lo = hb * Th, th = min(Th, H - h_lo);
  const int w_lo = wb * Tw, tw = min(Tw, W - w_lo);
  const int d_lo = db * Dt, d_hi = min(D, d_lo + Dt);
  const int oh_lo = max(0, F * h_lo - F / 2), oh_hi = min(Ho, F * (h_lo + th) + F / 2);
  const int ow_lo = max(0, F * w_lo - F / 2), ow_hi = min(Wo, F * (w_lo + tw) + F / 2);
  const int od_lo = max(0, F * d_lo - F / 2), od_hi = min(Do, F * d_hi + F / 2);
  const int n_oh = oh_hi - oh_lo;
  const int e_lo = ow_lo * C / vload * vload;  // the halo row's elements, widened to vload
  const int e_hi = min(rowlen, (ow_hi * C + vload - 1) / vload * vload);
  const int nv = (e_hi - e_lo) / vload;
  const int CC = C / CV;
  const int TTC = Th * Tw * C;
  const FastDiv by_nv = fast_div(nv);
  // Each thread keeps one column (w_l, c) of the tile, tw * CC <= NT of
  // them, and walks its rows r = row0, row0 + rstep, ... in both reductions.
  const int ncol = tw * CC, rstep = NT / ncol;
  const int row0 = threadIdx.x / ncol, col = threadIdx.x - row0 * ncol;
  const bool active = row0 < rstep;
  const int w_l = col / CC, c = (col - w_l * CC) * CV;
  const int cpitch = Tw * C;              // a tmp / accumulator row
  const int tcol = w_l * C + c;           // the column's offset in such a row

  for (int i = threadIdx.x; i < (Th + Tw) * 2 * F; i += NT) {
    const bool is_h = i < Th * 2 * F;
    const int j = is_h ? i : i - Th * 2 * F;
    const int t = j / (2 * F), k = j - t * 2 * F;
    const int in = (is_h ? h_lo : w_lo) + t, n_in = is_h ? H : W;
    const int o = F * in - F / 2 + k;
    htab[i] = in < n_in && o >= 0 && o < F * n_in ? tap_weight(o, in, n_in, inv_f) : 0.0f;
  }
  for (int i = threadIdx.x; i < 2 * TTC; i += NT) acc[i] = 0.0f;
  __syncthreads();
  // The column's W taps: weights and offsets in a halo row. The sums run
  // over all 2F taps without a branch; a tap of weight 0 (an output past the
  // volume's edge) reads the edge output instead, which the column reads
  // anyway, so no value enters that the plain version does not read.
  float ww[2 * F];
  int toff[2 * F];
#pragma unroll
  for (int k = 0; k < 2 * F; ++k) {
    ww[k] = active ? wtab[w_l * 2 * F + k] : 0.0f;
    toff[k] = min(max(F * (w_lo + w_l) - F / 2 + k, 0), Wo - 1) * C + c - e_lo;
  }

  auto load = [&](int od) {
    T* dst = buf + (od - od_lo) % RING * buf_elems;
    const T* src = dy + ((n * Do + od) * Ho + oh_lo) * static_cast<long long>(rowlen) + e_lo;
    for (int i = threadIdx.x; i < n_oh * nv; i += NT) {
      const int r = i / by_nv, v = i - r * nv;
      const T* s = src + static_cast<long long>(r) * rowlen + v * vload;
      T* d = dst + r * pitch + v * vload;
      if (vload > 1)
        cp_async16(d, s);
      else
        *d = *s;
    }
  };

  // Writes (and clears) this thread's accumulator run of plane p, row h_l.
  auto flush = [&](int p, int h_l) {
    float* A = acc + (p & 1) * TTC + h_l * cpitch + tcol;
    float v[CV];
    ld_f32<CV>(A, v);
    if (p >= d_lo && p < d_hi) {
      T* out = dx + (((n * D + p) * H + h_lo + h_l) * static_cast<long long>(W) + w_lo + w_l) * C + c;
      if constexpr (CV > 1) {
        store_vec<T, CV>(out, v);
      } else {
        out[0] = from_f32<T>(v[0]);
      }
    }
    float z[CV];
#pragma unroll
    for (int k = 0; k < CV; ++k) z[k] = 0.0f;
    st_f32<CV>(A, z);
  };

  int cur, i1;
  float l;
  taps(od_lo, D, inv_f, cur, i1, l);  // the plane the accumulators start on
  load(od_lo);  // od_lo < od_hi: every tile has a plane that reads it
  cp_async_commit();
  for (int od = od_lo; od < od_hi; ++od) {
    const T* plane = buf + (od - od_lo) % RING * buf_elems;
    if (od + 1 < od_hi) load(od + 1);
    cp_async_commit();
    cp_async_wait<1>();  // plane od's group is complete when one newer one pends
    __syncthreads();

    // over W: tmp[r][w_l][c] = sum over ow of w_w * dy, for every halo row r
    for (int r = active ? row0 : n_oh; r < n_oh; r += rstep) {
      const T* row = plane + r * pitch;
      float s[CV];
#pragma unroll
      for (int k = 0; k < CV; ++k) s[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 2 * F; ++k) {
        float v[CV];
        load_vec<T, CV>(row + toff[k], v);
#pragma unroll
        for (int kk = 0; kk < CV; ++kk) s[kk] += ww[k] * v[kk];
      }
      st_f32<CV>(tmp + r * cpitch + tcol, s);
    }
    __syncthreads();

    // over H, then into the planes i0(od) and i1(od) with the D weights
    int i0;
    taps(od, D, inv_f, i0, i1, l);
    const float wa = (1.0f - l) + (i1 == i0 ? l : 0.0f);
    const float wz = i1 != i0 ? l : 0.0f;
    const bool done = i0 > cur;  // plane cur is complete: no later od reads it
    for (int h_l = active ? row0 : th; h_l < th; h_l += rstep) {
      const int o0 = F * (h_lo + h_l) - F / 2;
      float r[CV];
#pragma unroll
      for (int k = 0; k < CV; ++k) r[k] = 0.0f;
#pragma unroll
      for (int k = 0; k < 2 * F; ++k) {  // edge taps of weight 0 as over W
        const float wgt = htab[h_l * 2 * F + k];
        float v[CV];
        ld_f32<CV>(tmp + (min(max(o0 + k, 0), Ho - 1) - oh_lo) * cpitch + tcol, v);
#pragma unroll
        for (int kk = 0; kk < CV; ++kk) r[kk] += wgt * v[kk];
      }
      if (done) flush(cur, h_l);
      const int a = h_l * cpitch + tcol;
      float v[CV];
      ld_f32<CV>(acc + (i0 & 1) * TTC + a, v);
#pragma unroll
      for (int k = 0; k < CV; ++k) v[k] += wa * r[k];
      st_f32<CV>(acc + (i0 & 1) * TTC + a, v);
      if (wz != 0.0f) {
        ld_f32<CV>(acc + (i1 & 1) * TTC + a, v);
#pragma unroll
        for (int k = 0; k < CV; ++k) v[k] += wz * r[k];
        st_f32<CV>(acc + (i1 & 1) * TTC + a, v);
      }
    }
    if (done) cur = i0;
  }
  for (int h_l = active ? row0 : th; h_l < th; h_l += rstep) flush(cur, h_l);
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

bool bad_shape(int N, int D, int H, int W, int C, int f) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < 1) return true;
  if (f != 2 && f != 4 && f != 8) return true;
  const long long rows = static_cast<long long>(N) * D * f * H * f;
  return rows > 0x7fffffffLL || static_cast<long long>(W) * f * C > 0x7fffffffLL;
}

// Shared memory of a forward block (ops/resize.py fwd_smem): two staged
// planes of min(hs + 1, H) source rows, each rounded up to 16 bytes, and
// the W tap table.
long long fwd_stage_bytes(int H, int W, int C, int hs, int esz) {
  const long long rows = hs + 1 < H ? hs + 1 : H;
  return round_up(rows * W * C * esz, 16);
}

long long fwd_smem(int H, int W, int C, int f, int hs, int esz) {
  return 2 * fwd_stage_bytes(H, W, C, hs, esz) + 8LL * W * f;
}

// Shared memory of a backward block (ops/resize.py bwd_smem): RING halo
// buffers of f*Th + f rows of `pitch` elements, the W-reduced rows (f32),
// two accumulator planes (f32) and the tap tables.
struct BwdLayout {
  long long pitch, buf_bytes, tmp_off, acc_off, tab_off, smem;
};

BwdLayout bwd_layout(int C, int f, int Th, int Tw, int esz) {
  BwdLayout L;
  const long long n_oh = static_cast<long long>(f) * Th + f;
  L.pitch = round_up((static_cast<long long>(f) * Tw + f) * C, 8) + 8;
  L.buf_bytes = round_up(n_oh * L.pitch * esz, 16);
  L.tmp_off = RING * L.buf_bytes;
  L.acc_off = L.tmp_off + round_up(n_oh * Tw * C * 4, 16);
  L.tab_off = L.acc_off + round_up(2LL * Th * Tw * C * 4, 16);
  L.smem = L.tab_off + (static_cast<long long>(Th) + Tw) * 2 * f * 4;
  return L;
}

template <typename K>
cudaError_t allow_smem(K kernel, long long smem) {
  if (smem <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

struct Shape {
  int N, D, H, W, C, f;
};

struct FwdPlan {
  int hs, dgroups, csplit, staged;
  long long smem;
};

struct BwdPlan {
  int Th, Tw, Dt;
  long long smem;
};

template <typename T, bool CH_VEC, bool ST_VEC>
int launch_fwd(const void* x, const void* skip, void* y, const Shape& s, const FwdPlan& p,
               cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  auto kernel = resize3d_fwd_kernel<T, VEC, CH_VEC, ST_VEC>;
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return int(err);
  const int hblocks = int(ceil_div(s.H, p.hs));
  const long long grid = static_cast<long long>(s.N) * s.D * p.dgroups * hblocks * p.csplit;
  const long long wc = static_cast<long long>(s.W) * s.C;
  const int src_vec = (wc * sizeof(T)) % 16 == 0 && aligned16(x);
  const long long stage_elems =
      fwd_stage_bytes(s.H, s.W, s.C, p.hs, sizeof(T)) / static_cast<long long>(sizeof(T));
  kernel<<<unsigned(grid), NT, size_t(p.smem), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(skip), static_cast<T*>(y), s.D, s.H, s.W,
      s.C, s.f, p.hs, p.dgroups, p.csplit, hblocks, p.staged, stage_elems, src_vec);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return int(err);
}

template <typename T>
int fwd_typed(const void* x, const void* skip, void* y, const Shape& s, const FwdPlan& p,
              cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const bool ch = s.C % VEC == 0;
  const bool sv = (static_cast<long long>(s.W) * s.f * s.C) % VEC == 0 && aligned16(y) &&
                  aligned16(skip);
  if (ch && sv) return launch_fwd<T, true, true>(x, skip, y, s, p, st);
  if (ch) return launch_fwd<T, true, false>(x, skip, y, s, p, st);
  if (sv) return launch_fwd<T, false, true>(x, skip, y, s, p, st);
  return launch_fwd<T, false, false>(x, skip, y, s, p, st);
}

template <typename T, int CV, int F>
int launch_bwd(const void* dy, void* dx, const Shape& s, const BwdPlan& p, const BwdLayout& L,
               cudaStream_t st) {
  if (p.Tw * (s.C / CV) > NT) return int(cudaErrorInvalidValue);  // a column per thread
  auto kernel = resize3d_bwd_kernel<T, CV, F>;
  cudaError_t err = allow_smem(kernel, L.smem);
  if (err != cudaSuccess) return int(err);
  const int hblocks = int(ceil_div(s.H, p.Th)), wblocks = int(ceil_div(s.W, p.Tw));
  const int dblocks = int(ceil_div(s.D, p.Dt));
  const long long grid = static_cast<long long>(s.N) * dblocks * hblocks * wblocks;
  const long long rowbytes = static_cast<long long>(s.W) * F * s.C * sizeof(T);
  const int vload = rowbytes % 16 == 0 && aligned16(dy) ? int(16 / sizeof(T)) : 1;
  kernel<<<unsigned(grid), NT, size_t(L.smem), st>>>(
      static_cast<const T*>(dy), static_cast<T*>(dx), s.D, s.H, s.W, s.C, p.Th, p.Tw, p.Dt,
      hblocks, wblocks, dblocks, int(L.pitch),
      L.buf_bytes / static_cast<long long>(sizeof(T)), int(L.tmp_off), int(L.acc_off),
      int(L.tab_off), vload);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches;
  return int(err);
}

template <typename T, int CV>
int bwd_factor(const void* dy, void* dx, const Shape& s, const BwdPlan& p, const BwdLayout& L,
               cudaStream_t st) {
  switch (s.f) {
    case 2: return launch_bwd<T, CV, 2>(dy, dx, s, p, L, st);
    case 4: return launch_bwd<T, CV, 4>(dy, dx, s, p, L, st);
    default: return launch_bwd<T, CV, 8>(dy, dx, s, p, L, st);
  }
}

template <typename T>
int bwd_typed(const void* dy, void* dx, const Shape& s, const BwdPlan& p, const BwdLayout& L,
              cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  if (s.C % VEC == 0 && aligned16(dx) && aligned16(dy))
    return bwd_factor<T, VEC>(dy, dx, s, p, L, st);
  return bwd_factor<T, 1>(dy, dx, s, p, L, st);
}

}  // namespace

extern "C" {

// y = up_f(x) [+ skip]: x (N, D, H, W, C), skip (null or like y) and y
// (N, D*f, H*f, W*f, C), contiguous, of one type: dtype 0 f32, 1 bf16.
// Plan (ops/resize.py fwd_plan): hs input rows per block, dgroups groups of
// each segment's output planes, csplit parts of each output row, staged 1
// to stage the source rows in shared memory (0: read them through L1), smem
// the block's shared-memory bytes (0 unstaged). Returns a cudaError_t as int: 0 when the
// launch was accepted, cudaErrorInvalidValue for a shape or plan it cannot
// take.
int resize3d_fwd(const void* x, const void* skip, void* y, int dtype, int N, int D, int H, int W,
                 int C, int f, int hs, int dgroups, int csplit, int staged, long long smem,
                 void* stream) {
  if (bad_shape(N, D, H, W, C, f) || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  const int esz = dtype == 1 ? 2 : 4;
  const long long nchunks = ceil_div(static_cast<long long>(W) * f * C * esz, 16);
  if (hs < 1 || hs > H || dgroups < 1 || dgroups > f || f % dgroups != 0 || csplit < 1 ||
      csplit > nchunks || csplit * nchunks > 0x7fffffffLL || (staged != 0 && staged != 1) ||
      smem != (staged ? fwd_smem(H, W, C, f, hs, esz) : 0) || smem > SMEM_MAX ||
      static_cast<long long>(N) * D * dgroups * ceil_div(H, hs) * csplit > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const Shape s{N, D, H, W, C, f};
  const FwdPlan p{hs, dgroups, csplit, staged, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd_typed<__nv_bfloat16>(x, skip, y, s, p, st)
                    : fwd_typed<float>(x, skip, y, s, p, st);
}

// dx (N, D, H, W, C) = the gradient of up_f at dy (N, D*f, H*f, W*f, C), both
// contiguous of one type (dtype 0 f32, 1 bf16), in one launch on the stream.
// Plan (ops/resize.py bwd_plan): Th x Tw input positions and Dt input planes
// per block, smem the block's shared-memory bytes.
// Returns a cudaError_t as int: 0 when the launch was accepted,
// cudaErrorInvalidValue for a shape or plan it cannot take.
int resize3d_bwd(const void* dy, void* dx, int dtype, int N, int D, int H, int W, int C, int f,
                 int Th, int Tw, int Dt, long long smem, void* stream) {
  if (bad_shape(N, D, H, W, C, f) || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  const int esz = dtype == 1 ? 2 : 4;
  if (Th < 1 || Th > H || Tw < 1 || Tw > W || Dt < 1 || Dt > D)
    return int(cudaErrorInvalidValue);
  const BwdLayout L = bwd_layout(C, f, Th, Tw, esz);
  const long long n_oh = static_cast<long long>(f) * Th + f;  // FastDiv's range: n * d < 2^32
  if (smem != L.smem || smem > SMEM_MAX || n_oh * L.pitch * L.pitch >= (1LL << 32) ||
      static_cast<long long>(N) * ceil_div(D, Dt) * ceil_div(H, Th) * ceil_div(W, Tw) > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  const Shape s{N, D, H, W, C, f};
  const BwdPlan p{Th, Tw, Dt, smem};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bwd_typed<__nv_bfloat16>(dy, dx, s, p, L, st)
                    : bwd_typed<float>(dy, dx, s, p, L, st);
}

// Kernel launches this library has made (accepted by the runtime).
long long resize3d_kernel_launches() { return g_launches; }

const char* resize3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
