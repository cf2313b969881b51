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
//
//   resize3d_fwd:  y = up_f(x) [+ skip], the 8 taps summed in f32 in
//     F.interpolate's nesting (d over h over w), the skip added in f32, one
//     rounding to the output type;
//   resize3d_bwd:  dx = up_f^T(dy) in gather form: every input element sums,
//     in a fixed order, the output elements that read it, so no atomics and
//     the same bits on every run. Separable: three 1-D passes (W, then H,
//     then D), each summing for input index i the 2f outputs
//     o in [f*i - f/2, f*i + 3f/2 - 1] with their weight
//     (1 - l(o)) [i0(o) == i] + l(o) [i1(o) == i], in ascending o. The
//     intermediates are f32; the last pass rounds once to dx's type.
//     A single-pass 3-D gather would sum (2f)^3 taps per input element
//     (4096 at f = 8, the attention maps) and read each dy element 8 times
//     from cache; the passes read dy once, from device memory, at any f.
//
// What bounds them on the H100: a few FLOP per byte, so device-memory
// bandwidth. Forward: one read of x (and skip), one write of y; y and skip
// are f^3 times x, so the output dominates. Backward: one read of dy, one
// write of dx; the passes add the f32 intermediates (dy / f and dy / f^2
// elements, written and read once each): at f = 2 on bf16 that is about
// 3.6x the bound's bytes, at f = 8 on f32 about 1.3x.
//
// Layout: a forward block takes one output row (n, od, oh): its D and H taps
// and weights are computed once, and its threads walk the row's W_out * C
// elements in vectors of VEC channels (16 bytes where C and the pointers
// allow, down to one element for the 13-channel f32 attention maps), so a
// warp stores neighbouring vectors. A backward pass views its source as
// (outer, f * n, inner) and its destination as (outer, n, inner), inner the
// contiguous elements after the axis; a thread owns VEC consecutive inner
// elements of one (outer, i). All offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int MAX_BLOCKS = 132 * 16;  // grid-stride blocks of a backward pass

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

// Source taps of output index o on an axis of n inputs at factor 1/inv_f:
// i0, i1 and the weight l of i1 (F.interpolate's align_corners=False rule).
__device__ __forceinline__ void taps(int o, int n, float inv_f, int& i0, int& i1, float& l) {
  float s = (float(o) + 0.5f) * inv_f - 0.5f;
  s = s < 0.0f ? 0.0f : s;
  i0 = int(s);
  l = s - float(i0);
  i1 = i0 < n - 1 ? i0 + 1 : i0;
}

// y (N, D*f, H*f, W*f, C) = up_f(x (N, D, H, W, C)) [+ skip (like y)].
template <typename T, int VEC>
__global__ void __launch_bounds__(NT)
resize3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ skip, T* __restrict__ y,
                    int D, int H, int W, int C, int f) {
  const float inv_f = 1.0f / float(f);
  const int Do = D * f, Ho = H * f, Wo = W * f;
  const long long row = blockIdx.x;  // (n, od, oh)
  const int oh = int(row % Ho);
  const int od = int((row / Ho) % Do);
  const long long n = row / (static_cast<long long>(Ho) * Do);
  int d0, d1, h0, h1;
  float ld, lh;
  taps(od, D, inv_f, d0, d1, ld);
  taps(oh, H, inv_f, h0, h1, lh);
  const long long wc = static_cast<long long>(W) * C;
  const long long plane = static_cast<long long>(H) * wc;
  const T* xn = x + n * D * plane;
  const T* r00 = xn + d0 * plane + h0 * wc;
  const T* r01 = xn + d0 * plane + h1 * wc;
  const T* r10 = xn + d1 * plane + h0 * wc;
  const T* r11 = xn + d1 * plane + h1 * wc;
  const float wd0 = 1.0f - ld, wh0 = 1.0f - lh;
  const long long out0 = row * Wo * C;
  const int cv = C / VEC;
  for (int j = threadIdx.x; j < Wo * cv; j += NT) {
    const int ow = j / cv;
    const int c = (j - ow * cv) * VEC;
    int w0, w1;
    float lw;
    taps(ow, W, inv_f, w0, w1, lw);
    const float ww0 = 1.0f - lw;
    const long long a = static_cast<long long>(w0) * C + c, b = static_cast<long long>(w1) * C + c;
    float v000[VEC], v001[VEC], v010[VEC], v011[VEC], v100[VEC], v101[VEC], v110[VEC],
        v111[VEC], out[VEC];
    load_vec<T, VEC>(r00 + a, v000);
    load_vec<T, VEC>(r00 + b, v001);
    load_vec<T, VEC>(r01 + a, v010);
    load_vec<T, VEC>(r01 + b, v011);
    load_vec<T, VEC>(r10 + a, v100);
    load_vec<T, VEC>(r10 + b, v101);
    load_vec<T, VEC>(r11 + a, v110);
    load_vec<T, VEC>(r11 + b, v111);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      out[k] = wd0 * (wh0 * (ww0 * v000[k] + lw * v001[k]) + lh * (ww0 * v010[k] + lw * v011[k])) +
               ld * (wh0 * (ww0 * v100[k] + lw * v101[k]) + lh * (ww0 * v110[k] + lw * v111[k]));
    const long long o = out0 + static_cast<long long>(ow) * C + c;
    if (skip != nullptr) {
      float s[VEC];
      load_vec<T, VEC>(skip + o, s);
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[k] += s[k];
    }
    store_vec<T, VEC>(y + o, out);
  }
}

// dst (outer, n, inner) [i] = sum over the outputs o of src (outer, f*n,
// inner) that read input i, in ascending o, weighted as the forward reads.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(NT)
resize3d_bwd_axis_kernel(const Tin* __restrict__ src, Tout* __restrict__ dst, long long outer,
                         int n, long long inner, int f) {
  const float inv_f = 1.0f / float(f);
  const int no = n * f;
  const long long iv = inner / VEC;
  const long long total = outer * n * iv;
  for (long long idx = static_cast<long long>(blockIdx.x) * NT + threadIdx.x; idx < total;
       idx += static_cast<long long>(gridDim.x) * NT) {
    const long long jv = idx % iv;
    const long long r = idx / iv;
    const int i = int(r % n);
    const long long q = r / n;
    const Tin* base = src + q * no * inner + jv * VEC;
    const int lo = max(0, f * i - f / 2), hi = min(no - 1, f * i + f + f / 2 - 1);
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int o = lo; o <= hi; ++o) {
      int i0, i1;
      float l;
      taps(o, n, inv_f, i0, i1, l);
      const float wgt = (i0 == i ? 1.0f - l : 0.0f) + (i1 == i ? l : 0.0f);
      if (wgt == 0.0f) continue;
      float v[VEC];
      load_vec<Tin, VEC>(base + static_cast<long long>(o) * inner, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += wgt * v[k];
    }
    store_vec<Tout, VEC>(dst + r * inner + jv * VEC, acc);
  }
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The widest VEC (elements) of at most 16 bytes of the wider of the two
// types that divides inner and to which every pointer is aligned.
int pick_vec(long long inner, int in_bytes, int out_bytes, const void* a, const void* b,
             const void* c) {
  const int wide = in_bytes > out_bytes ? in_bytes : out_bytes;
  for (int vec = 16 / wide; vec > 1; vec /= 2) {
    if (inner % vec == 0 && aligned(a, vec * in_bytes) && aligned(b, vec * out_bytes) &&
        aligned(c, vec * out_bytes))
      return vec;
  }
  return 1;
}

template <typename T, int VEC>
void launch_fwd(const void* x, const void* skip, void* y, int N, int D, int H, int W, int C,
                int f, cudaStream_t st) {
  const long long rows = static_cast<long long>(N) * D * f * H * f;
  resize3d_fwd_kernel<T, VEC><<<static_cast<unsigned>(rows), NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(skip), static_cast<T*>(y), D, H, W, C, f);
}

template <typename T>
int fwd_typed(const void* x, const void* skip, void* y, int N, int D, int H, int W, int C, int f,
              cudaStream_t st) {
  const int vec = pick_vec(C, sizeof(T), sizeof(T), x, skip, y);
  switch (vec) {
    case 8: launch_fwd<T, 8>(x, skip, y, N, D, H, W, C, f, st); break;
    case 4: launch_fwd<T, 4>(x, skip, y, N, D, H, W, C, f, st); break;
    case 2: launch_fwd<T, 2>(x, skip, y, N, D, H, W, C, f, st); break;
    default: launch_fwd<T, 1>(x, skip, y, N, D, H, W, C, f, st); break;
  }
  return int(cudaGetLastError());
}

template <typename Tin, typename Tout, int VEC>
void launch_axis(const void* src, void* dst, long long outer, int n, long long inner, int f,
                 cudaStream_t st) {
  const long long total = outer * n * (inner / VEC);
  const long long want = (total + NT - 1) / NT;
  const int blocks = int(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  resize3d_bwd_axis_kernel<Tin, Tout, VEC><<<blocks, NT, 0, st>>>(
      static_cast<const Tin*>(src), static_cast<Tout*>(dst), outer, n, inner, f);
}

template <typename Tin, typename Tout>
int axis_typed(const void* src, void* dst, long long outer, int n, long long inner, int f,
               cudaStream_t st) {
  const int vec = pick_vec(inner, sizeof(Tin), sizeof(Tout), src, dst, nullptr);
  switch (vec) {
    case 4: launch_axis<Tin, Tout, 4>(src, dst, outer, n, inner, f, st); break;
    case 2: launch_axis<Tin, Tout, 2>(src, dst, outer, n, inner, f, st); break;
    default: launch_axis<Tin, Tout, 1>(src, dst, outer, n, inner, f, st); break;
  }
  return int(cudaGetLastError());
}

bool bad_shape(int N, int D, int H, int W, int C, int f) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < 1) return true;
  if (f != 2 && f != 4 && f != 8) return true;
  const long long rows = static_cast<long long>(N) * D * f * H * f;
  return rows > 0x7fffffffLL || static_cast<long long>(W) * f * C > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// y = up_f(x) [+ skip]: x (N, D, H, W, C), skip (null or like y) and y
// (N, D*f, H*f, W*f, C), contiguous, of one type: dtype 0 f32, 1 bf16.
// Returns a cudaError_t as int: 0 when the launch was accepted.
int resize3d_fwd(const void* x, const void* skip, void* y, int dtype, int N, int D, int H,
                 int W, int C, int f, void* stream) {
  if (bad_shape(N, D, H, W, C, f) || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? fwd_typed<__nv_bfloat16>(x, skip, y, N, D, H, W, C, f, st)
                    : fwd_typed<float>(x, skip, y, N, D, H, W, C, f, st);
}

// dx (N, D, H, W, C) = the gradient of up_f at dy (N, D*f, H*f, W*f, C), both
// contiguous of one type (dtype 0 f32, 1 bf16), through the f32 scratch
// t1 (N, D*f, H*f, W, C) and t2 (N, D*f, H, W, C): three launches on the
// stream. Returns a cudaError_t as int: 0 when all were accepted.
int resize3d_bwd(const void* dy, void* t1, void* t2, void* dx, int dtype, int N, int D, int H,
                 int W, int C, int f, void* stream) {
  if (bad_shape(N, D, H, W, C, f) || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long Do = static_cast<long long>(D) * f, Ho = static_cast<long long>(H) * f;
  int err = dtype == 1
                ? axis_typed<__nv_bfloat16, float>(dy, t1, N * Do * Ho, W, C, f, st)
                : axis_typed<float, float>(dy, t1, N * Do * Ho, W, C, f, st);
  if (err) return err;
  err = axis_typed<float, float>(t1, t2, N * Do, H, static_cast<long long>(W) * C, f, st);
  if (err) return err;
  const long long hwc = static_cast<long long>(H) * W * C;
  return dtype == 1 ? axis_typed<float, __nv_bfloat16>(t2, dx, N, D, hwc, f, st)
                    : axis_typed<float, float>(t2, dx, N, D, hwc, f, st);
}

const char* resize3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
