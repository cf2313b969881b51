// Fused GroupNorm-apply -> ReLU -> 3x3x3 SAME conv (+ residual) for Hopper.
//
// Replaces four TPU kernels of the JAX package, which compute the same
// function on TPU-shaped layouts:
//   - multimodal_pl_tpu/ops/pallas/bdx.py::bdx_gn_conv (prologue on, optional
//     residual): every stride-1 residual block of the FEAM U-Net;
//   - multimodal_pl_tpu/ops/pallas/bk3_conv.py::bk3_impl (prologue off): the
//     second conv of every stride-2 block;
//   - multimodal_pl_tpu/ops/pallas/k2_conv.py::k2_conv (prologue off): the
//     training conv's forward, and its dx on flipped taps with the channels
//     swapped (ops/conv3x3.py::conv3x3_train);
//   - multimodal_pl_tpu/ops/pallas/k2_conv.py::k2_gn_conv (prologue on, no
//     residual): the refiner's gradient-free pass in the train step.
//
// What it computes, for NDHWC bf16 x (B, D, H, W, Cin):
//   t   = bf16(relu(f32(x) * a[b, c] + b[b, c]))   (prologue on; t = x when off)
//   t   = 0 outside the volume                      (SAME zero padding applies
//                                                    AFTER the prologue)
//   y   = sum_{taps, ci} t * w                      (f32 accumulation)
//   out = bf16(y + f32(res))                        (res optional)
// a and b are the folded GroupNorm rows (B, Cin) f32; w is packed
// (27, Cin, Cout) bf16 with tap index kd*9 + kh*3 + kw. Cin and Cout are
// multiples of 8 (the refiner's stages are 24 wide): a channel chunk or an
// output-channel block that runs past the tensor is zero-filled in shared
// memory up to the 16-wide WMMA step, and its outputs are not stored.
//
// Design (an implicit GEMM: M = output voxels, N = Cout, K = 27 * Cin):
//   - one block computes a 2 x 4 x 16 (D x H x W) output tile against BN
//     output channels; each of its 8 warps owns one 16-voxel W row and holds
//     BN/16 WMMA f32 accumulators;
//   - per Cin chunk of KC channels the block loads the (4 x 6 x 18) halo tile
//     into shared memory once, applying the prologue and the coordinate mask
//     while it loads, so the normalized tensor never exists in device memory
//     and padded positions are exact zeros of the normalized tensor;
//   - a tap's A operand is then a plain 16-row window of that halo row at
//     offset kw (row stride = the padded channel stride), so the 27 taps reuse
//     one halo load without any im2col copy;
//   - weights are staged per depth tap (9 taps x KC x BN) in shared memory;
//   - the epilogue stages the accumulators through shared memory and writes
//     16-byte vectors with the residual added in f32.
// All global offsets are 64-bit: with flip-TTA a tile batch reaches B = 32,
// about 2.4e9 elements at the full-resolution stage.
//
// What bounds it on the H100: even the narrowest stage (Cin = Cout = 32) does
// 27 * 32 * 32 * 2 = 55,296 FLOP per output voxel against 128 bytes of bf16
// input and output, about 430 FLOP/byte, above the card's ~295 FLOP/byte
// ridge; the wider stages are further above it. So the bound is the tensor
// cores, and what keeps this version below them is its issue path: WMMA
// (mma.sync, not wgmma), operands re-read from shared memory by every warp,
// the halo tile re-read 4*6*18 / (2*4*16) = 3.4 times from device memory,
// and one buffer with a block-wide barrier per stage (no load/compute
// overlap). wgmma, TMA and a multi-stage pipeline are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TD = 2, TH = 4, TW = 16;                // output tile
constexpr int HD = TD + 2, HH = TH + 2, HW = TW + 2;  // halo tile
constexpr int NWARPS = TD * TH;                       // one warp per W row
constexpr int NTHREADS = NWARPS * 32;

template <int KC, int BN>
struct Smem {
  // Row strides in elements. WMMA wants 32-byte aligned row starts; the +16
  // keeps that and staggers rows across banks.
  static constexpr int XS = KC + 16;
  static constexpr int WS = BN + 16;
  static constexpr int OS = BN + 8;  // f32 staging stride
  static constexpr int halo_elems = HD * HH * HW * XS;
  static constexpr int w_elems = 9 * KC * WS;
  static constexpr size_t main_bytes = size_t(halo_elems + w_elems) * 2;
  static constexpr size_t out_bytes = size_t(TD * TH * TW) * OS * 4;
  static constexpr size_t bytes = main_bytes > out_bytes ? main_bytes : out_bytes;
};

template <int KC, int BN>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_gn_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ ga, const float* __restrict__ gb,
                  const __nv_bfloat16* __restrict__ res,
                  __nv_bfloat16* __restrict__ out, int D, int H, int W,
                  int Cin, int Cout, int tiles_d, int tiles_h, int tiles_w) {
  using S = Smem<KC, BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = xs + S::halo_elems;
  float* os = reinterpret_cast<float*>(smem_raw);  // aliases xs/ws after the K loop

  long long t = blockIdx.x;
  const int tw = int(t % tiles_w);
  t /= tiles_w;
  const int th = int(t % tiles_h);
  t /= tiles_h;
  const int td = int(t % tiles_d);
  const long long bi = t / tiles_d;
  const int d0 = td * TD, h0 = th * TH, w0 = tw * TW;
  const int n0 = blockIdx.y * BN;

  const int warp = threadIdx.x / 32;
  const int wd = warp / TH, wh = warp % TH;

  constexpr int NF = BN / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);

  const bool prologue = ga != nullptr;
  constexpr int KV = KC / 8;  // 16-byte vectors per halo row
  constexpr int NV = BN / 8;  // 16-byte vectors per weight row

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    // ---- halo tile: load, prologue, coordinate mask ---------------------
    for (int i = threadIdx.x; i < HD * HH * HW * KV; i += NTHREADS) {
      const int v = i % KV;
      const int vox = i / KV;
      const int lw = vox % HW;
      const int lh = (vox / HW) % HH;
      const int ld = vox / (HW * HH);
      const int gd = d0 - 1 + ld, gh = h0 - 1 + lh, gw = w0 - 1 + lw;
      const int c = c0 + v * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c < Cin && gd >= 0 && gd < D && gh >= 0 && gh < H && gw >= 0 && gw < W) {
        const long long off =
            (((bi * D + gd) * H + gh) * (long long)W + gw) * Cin + c;
        val = *reinterpret_cast<const uint4*>(x + off);
        if (prologue) {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
          const float* ar = ga + bi * Cin + c;
          const float* br = gb + bi * Cin + c;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float f =
                __fadd_rn(__fmul_rn(__bfloat162float(e[j]), ar[j]), br[j]);
            e[j] = __float2bfloat16_rn(fmaxf(f, 0.0f));
          }
        }
      }
      *reinterpret_cast<uint4*>(xs + vox * S::XS + v * 8) = val;
    }
    for (int kd = 0; kd < 3; ++kd) {
      // ---- weights of the 9 taps at depth offset kd -----------------------
      for (int i = threadIdx.x; i < 9 * KC * NV; i += NTHREADS) {
        const int v = i % NV;
        const int r = (i / NV) % KC;
        const int tap = i / (NV * KC);
        const int n = n0 + v * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n < Cout && c0 + r < Cin)
          val = *reinterpret_cast<const uint4*>(
              w + ((long long)(kd * 9 + tap) * Cin + c0 + r) * Cout + n);
        *reinterpret_cast<uint4*>(ws + (tap * KC + r) * S::WS + v * 8) = val;
      }
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int kh = tap / 3, kw = tap % 3;
        const __nv_bfloat16* arow =
            xs + (((wd + kd) * HH + (wh + kh)) * HW + kw) * S::XS;
#pragma unroll
        for (int k = 0; k < KC; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, arow + k, S::XS);
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
            wmma::load_matrix_sync(bf, ws + (tap * KC + k) * S::WS + f * 16, S::WS);
            wmma::mma_sync(acc[f], af, bf, acc[f]);
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- epilogue: stage, add residual in f32, write bf16 ------------------
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(os + (warp * TW) * S::OS + f * 16, acc[f], S::OS,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < TD * TH * TW * NV; i += NTHREADS) {
    const int v = i % NV;
    const int m = i / NV;
    const int lw = m % TW;
    const int lh = (m / TW) % TH;
    const int ld = m / (TW * TH);
    const int gd = d0 + ld, gh = h0 + lh, gw = w0 + lw;
    const int n = n0 + v * 8;
    if (gd >= D || gh >= H || gw >= W || n >= Cout) continue;
    const long long off =
        (((bi * D + gd) * H + gh) * (long long)W + gw) * Cout + n;
    const float* src = os + m * S::OS + v * 8;
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = src[j];
    if (res != nullptr) {
      uint4 rv = *reinterpret_cast<const uint4*>(res + off);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] += __bfloat162float(e[j]);
    }
    uint4 o;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(r[j]);
    *reinterpret_cast<uint4*>(out + off) = o;
  }
}

template <int KC, int BN>
cudaError_t launch(const void* x, const void* w, const float* a,
                   const float* b, const void* res, void* out, int B, int D,
                   int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const size_t smem = Smem<KC, BN>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_gn_kernel<KC, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int tiles_d = (D + TD - 1) / TD;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const long long nblocks = (long long)B * tiles_d * tiles_h * tiles_w;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  dim3 grid(unsigned(nblocks), unsigned((Cout + BN - 1) / BN));
  conv3x3_gn_kernel<KC, BN><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      a, b, static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), D, H, W, Cin, Cout, tiles_d, tiles_h,
      tiles_w);
  return cudaGetLastError();
}

template <int KC>
cudaError_t dispatch_bn(const void* x, const void* w, const float* a,
                        const float* b, const void* res, void* out, int B,
                        int D, int H, int W, int Cin, int Cout,
                        cudaStream_t s) {
  if (Cout % 64 == 0) return launch<KC, 64>(x, w, a, b, res, out, B, D, H, W, Cin, Cout, s);
  if (Cout % 32 == 0) return launch<KC, 32>(x, w, a, b, res, out, B, D, H, W, Cin, Cout, s);
  return launch<KC, 16>(x, w, a, b, res, out, B, D, H, W, Cin, Cout, s);
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int: 0 when the launch was accepted. a and b are
// both null (prologue off) or both set; res may be null.
int conv3x3_gn_bf16(const void* x, const void* w, const void* a,
                    const void* b, const void* res, void* out, int B, int D,
                    int H, int W, int Cin, int Cout, void* stream) {
  if (Cin % 8 != 0 || Cout % 8 != 0 || B < 1 || D < 1 || H < 1 || W < 1)
    return int(cudaErrorInvalidValue);
  if ((a == nullptr) != (b == nullptr)) return int(cudaErrorInvalidValue);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      Cin % 32 == 0
          ? dispatch_bn<32>(x, w, fa, fb, res, out, B, D, H, W, Cin, Cout, s)
          : dispatch_bn<16>(x, w, fa, fb, res, out, B, D, H, W, Cin, Cout, s);
  return int(err);
}

const char* conv3x3_gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
