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
//   t   = bf16(relu(f32(x) * a[b, c] + b[b, c]))   (prologue on; t = x when off;
//                                                    unfused mul then add, as
//                                                    bdx.py:141-143 rounds)
//   t   = 0 outside the volume                      (SAME zero padding applies
//                                                    AFTER the prologue)
//   y   = sum_{taps, ci} t * w                      (f32 accumulation)
//   out = bf16(y + f32(res))                        (res optional)
// a and b are the folded GroupNorm rows (B, Cin) f32. Cin and Cout are
// multiples of 8; the wrapper (ops/conv3x3.py) packs w into the tile order
// below, zero-padded to whole Cin chunks of KC and output blocks of N.
//
// What bounds it on the H100: per output voxel 54 * Cin * Cout FLOP against
// 2 * (Cin + Cout) bytes of input and output (plus the residual); at the
// narrowest stage (32 -> 32, with the residual) that is about 290 FLOP/byte,
// at the card's ~295 FLOP/byte ridge, so tensor cores and memory bound it
// about equally there (0.53 vs 0.54 ms at B = 4 x 64 x 192 x 192), and the
// wider stages are bound by the tensor cores (989 TFLOP/s dense bf16).
// The deep stages (4 x 12 x 12, 2 x 6 x 6) have too few output tiles to fill
// 132 SMs.
//
// Design (an implicit GEMM: M = output voxels, N = Cout, K = 27 * Cin):
//   - a block of two warpgroups holds N output channels (N up to 256: every
//     Cout of the models in one block, so each halo is loaded once) for
//     M = 256 voxels, a 4 x 4 x 16 (D x H x W) tile, at N <= 128, or 128
//     voxels (2 x 4 x 16) at N = 192, 256, where the f32 accumulators
//     (N / 2 registers per thread and row block) allow one row block per
//     warpgroup; each warp owns 16-voxel W rows, and its warpgroup issues
//     wgmma.mma_async m64nNk16;
//   - A comes from registers: the A operand of tap (kd, kh, kw) is the halo
//     row shifted by kw voxels, which a shared-memory descriptor cannot
//     express (its core matrices are 8 rows x 16 bytes), so ldmatrix.x4 loads
//     it with one address per row into the m16k16 fragment layout, the
//     per-warp A layout of wgmma's register form; halo rows are padded to an
//     odd number of 16-byte units, so the 8 rows of a matrix hit 8 banks;
//   - B, the packed weights, is read by wgmma through a descriptor: a stage
//     holds the 9 taps of one depth plane kd of one Cin chunk of KC
//     channels, in wgmma's no-swizzle K-major core-matrix order
//     ([tap][N/8][KC/8][8 x 8]), one contiguous run in global memory;
//   - one barrier per (Cin chunk, kd) plane: its 9 taps stream through the
//     tensor cores with up to two taps' wgmma groups in flight (A fragments
//     in 2-3 register slots) while the next tap's fragments load;
//   - loads are in flight during the math: two weight stages and two halo
//     stages, filled by cp.async (16-byte copies; out-of-volume and
//     channel-tail vectors zero-filled by the copy), so the next plane's
//     weights and the next chunk's halo stream in while the tensor cores work;
//   - the prologue and the coordinate mask are applied once per staged halo
//     element, in shared memory, after the copy lands (a copy's zero is a
//     zero of x, not of relu(x * a + b), so positions outside the volume are
//     left at zero by coordinate); the a, b rows of the sample are staged in
//     shared memory once per block;
//   - at N <= 64 two blocks share an SM (the wrapper picks a KC whose stages
//     fit half the shared memory, and registers are capped at 128), so one
//     block's loads, prologue and epilogue overlap the other's math;
//   - when the tiles give fewer than 2 x 132 blocks, K is split across
//     blocks (grid.z) in (chunk, kd) planes: each writes its f32 partial tile
//     to a workspace, and a second launch sums the partials in split order,
//     adds the residual and rounds to bf16 (no float atomics: the same bits
//     from run to run);
//   - the epilogue stages the accumulators through shared memory and writes
//     16-byte vectors with the residual added in f32.
// The wrapper (ops/conv3x3.py::plan) picks KC, N and the split per shape.
// All global offsets are 64-bit: with flip-TTA a tile batch reaches B = 32,
// about 2.4e9 elements at the full-resolution stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 4, TW = 16;                        // output tile H x W; D per N
constexpr int HH = TH + 2, HW = TW + 2;               // halo tile H x W
constexpr int M_BASE = 2 * TH * TW;                   // output voxels per m64 block pair
constexpr int NTHREADS = 256;                         // two warpgroups
constexpr int WSTAGES = 2;                            // weight stages (one kd plane each)
constexpr int MAX_SMEM = 232448;                      // 227 KB per block

using bf16 = __nv_bfloat16;

struct Params {
  const bf16* x;
  const bf16* w;    // packed [chunk][nblock][tap][N/8][KC/8][8][8]
  const float* a;   // (B, Cin) or null
  const float* b;
  const bf16* res;  // (B, D, H, W, Cout) or null
  bf16* out;
  float* ws;        // split-K partials [split][B * D * H * W][Cout], or null
  int B, D, H, W, Cin, Cout, KC, nchunks, nblocks, split;
  int tiles_d, tiles_h, tiles_w;
};

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (between core matrices along K) and stride byte offset (between
// 8-row core matrices along N), all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving accumulator or fragment registers across
// the asynchronous wgmma (which reads and writes them after it is issued).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16 f32 += bf16 (A in registers) x bf16 (B K-major in
// shared memory). Operands %0-%3 are A, %4 the B descriptor, %5 the scale-d
// flag, %6 on the N / 2 accumulators.
#define WG_S0 "%6, %7, %8, %9"
#define WG_S1 "%10, %11, %12, %13"
#define WG_S2 "%14, %15, %16, %17"
#define WG_S3 "%18, %19, %20, %21"
#define WG_S4 "%22, %23, %24, %25"
#define WG_S5 "%26, %27, %28, %29"
#define WG_S6 "%30, %31, %32, %33"
#define WG_S7 "%34, %35, %36, %37"
#define WG_S8 "%38, %39, %40, %41"
#define WG_S9 "%42, %43, %44, %45"
#define WG_S10 "%46, %47, %48, %49"
#define WG_S11 "%50, %51, %52, %53"
#define WG_S12 "%54, %55, %56, %57"
#define WG_S13 "%58, %59, %60, %61"
#define WG_S14 "%62, %63, %64, %65"
#define WG_S15 "%66, %67, %68, %69"
#define WG_S16 "%70, %71, %72, %73"
#define WG_S17 "%74, %75, %76, %77"
#define WG_S18 "%78, %79, %80, %81"
#define WG_S19 "%82, %83, %84, %85"
#define WG_S20 "%86, %87, %88, %89"
#define WG_S21 "%90, %91, %92, %93"
#define WG_S22 "%94, %95, %96, %97"
#define WG_S23 "%98, %99, %100, %101"
#define WG_S24 "%102, %103, %104, %105"
#define WG_S25 "%106, %107, %108, %109"
#define WG_S26 "%110, %111, %112, %113"
#define WG_S27 "%114, %115, %116, %117"
#define WG_S28 "%118, %119, %120, %121"
#define WG_S29 "%122, %123, %124, %125"
#define WG_S30 "%126, %127, %128, %129"
#define WG_S31 "%130, %131, %132, %133"
#define WG_L8 WG_S0 ", " WG_S1
#define WG_L12 WG_L8 ", " WG_S2
#define WG_L16 WG_L12 ", " WG_S3
#define WG_L24 WG_L16 ", " WG_S4 ", " WG_S5
#define WG_L32 WG_L24 ", " WG_S6 ", " WG_S7
#define WG_L48 WG_L32 ", " WG_S8 ", " WG_S9 ", " WG_S10 ", " WG_S11
#define WG_L64 WG_L48 ", " WG_S12 ", " WG_S13 ", " WG_S14 ", " WG_S15
#define WG_L96 WG_L64 ", " WG_S16 ", " WG_S17 ", " WG_S18 ", " WG_S19 ", " WG_S20 ", " \
    WG_S21 ", " WG_S22 ", " WG_S23
#define WG_L128 WG_L96 ", " WG_S24 ", " WG_S25 ", " WG_S26 ", " WG_S27 ", " WG_S28 ", " \
    WG_S29 ", " WG_S30 ", " WG_S31
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_O8 WG_F4(0), WG_F4(4)
#define WG_O12 WG_O8, WG_F4(8)
#define WG_O16 WG_O12, WG_F4(12)
#define WG_O24 WG_O16, WG_F4(16), WG_F4(20)
#define WG_O32 WG_O24, WG_F4(24), WG_F4(28)
#define WG_O48 WG_O32, WG_F4(32), WG_F4(36), WG_F4(40), WG_F4(44)
#define WG_O64 WG_O48, WG_F4(48), WG_F4(52), WG_F4(56), WG_F4(60)
#define WG_O96 WG_O64, WG_F4(64), WG_F4(68), WG_F4(72), WG_F4(76), WG_F4(80), WG_F4(84), \
    WG_F4(88), WG_F4(92)
#define WG_O128 WG_O96, WG_F4(96), WG_F4(100), WG_F4(104), WG_F4(108), WG_F4(112), \
    WG_F4(116), WG_F4(120), WG_F4(124)

template <int N>
struct Wgmma;

#define DEFINE_WGMMA(NN, R)                                                              \
  template <>                                                                            \
  struct Wgmma<NN> {                                                                     \
    static __device__ __forceinline__ void mma(float (&d)[R], uint32_t (&a)[4],          \
                                               uint64_t desc) {                          \
      int scale_d = 1;                                                                   \
      asm volatile(                                                                      \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"                                    \
          "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 {" WG_L##R          \
          "}, {%0, %1, %2, %3}, %4, p, 1, 1, 0;\n}\n"                                    \
          : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]), "+l"(desc), "+r"(scale_d),   \
            WG_O##R);                                                                    \
    }                                                                                    \
  };

DEFINE_WGMMA(16, 8)
DEFINE_WGMMA(24, 12)
DEFINE_WGMMA(32, 16)
DEFINE_WGMMA(48, 24)
DEFINE_WGMMA(64, 32)
DEFINE_WGMMA(96, 48)
DEFINE_WGMMA(128, 64)
DEFINE_WGMMA(192, 96)
DEFINE_WGMMA(256, 128)

// ---- tile geometry and shared-memory plan -----------------------------------
//
// MT m64 row blocks per warpgroup: a block covers M = 128 * MT output voxels,
// a (2 * MT) x 4 x 16 tile. N <= 128 takes MT = 2 (the accumulators of two
// blocks fit the registers), halving the weight and halo traffic per output
// voxel; N = 192, 256 take MT = 1.

__host__ __device__ constexpr int mt_of(int N) { return N <= 128 ? 2 : 1; }
__host__ __device__ constexpr int tile_d(int N) { return 2 * mt_of(N); }
__host__ __device__ constexpr int halo_vox(int N) { return (tile_d(N) + 2) * HH * HW; }
__host__ __device__ inline int halo_bytes(int KC, int N) { return halo_vox(N) * (KC + 8) * 2; }
__host__ __device__ inline int wstage_bytes(int KC, int N) { return 9 * KC * N * 2; }
__host__ __device__ inline int halo_bufs(int nchunks) { return nchunks < 2 ? nchunks : 2; }

__host__ __device__ inline size_t smem_bytes(int KC, int N, int nchunks) {
  const size_t main = size_t(halo_bufs(nchunks)) * halo_bytes(KC, N) +
                      size_t(WSTAGES) * wstage_bytes(KC, N);
  const size_t epi = size_t(M_BASE * mt_of(N)) * (N + 4) * 4;
  return (main > epi ? main : epi) + size_t(2) * nchunks * KC * 4;
}

// ---- the conv kernel --------------------------------------------------------

struct Block {  // where a block's output tile sits
  long long bi;
  int d0, h0, w0;
};

// The 9 taps of depth plane j % 3 of Cin chunk j / 3 for output block nb.
template <int N>
__device__ __forceinline__ void load_weights(const Params& p, unsigned char* dst, int j,
                                             int nb) {
  const int bytes = wstage_bytes(p.KC, N);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(p.w) +
                             (((long long)(j / 3) * p.nblocks + nb) * 3 + j % 3) * bytes;
  for (int v = threadIdx.x; v < bytes / 16; v += NTHREADS) cp_async16(dst + v * 16, src + v * 16, 16);
}

// The halo of channel chunk c (KC = 16 * KSTEPS channels); out-of-volume and
// c >= Cin vectors are zero-filled by the copy.
template <int N, int KSTEPS>
__device__ __forceinline__ void load_halo(const Params& p, bf16* dst, int c, const Block& bk) {
  constexpr int V = 2 * KSTEPS, XS = 16 * KSTEPS + 8;
  for (int i = threadIdx.x; i < halo_vox(N) * V; i += NTHREADS) {
    const int v = i % V, vox = i / V;
    const int gw = bk.w0 - 1 + vox % HW, gh = bk.h0 - 1 + (vox / HW) % HH;
    const int gd = bk.d0 - 1 + vox / (HW * HH);
    const int ch = c * 16 * KSTEPS + v * 8;
    const bool ok = ch < p.Cin && gd >= 0 && gd < p.D && gh >= 0 && gh < p.H && gw >= 0 && gw < p.W;
    const bf16* src =
        ok ? p.x + (((bk.bi * p.D + gd) * p.H + gh) * (long long)p.W + gw) * p.Cin + ch : p.x;
    cp_async16(dst + vox * XS + v * 8, src, ok ? 16 : 0);
  }
}

// bf16(relu(f32(t) * a + b)) in place, in bdx's rounding order, at positions
// inside the volume and below Cin; the rest stays zero.
template <int N, int KSTEPS>
__device__ __forceinline__ void apply_prologue(const Params& p, bf16* hb, int c, const float* ar,
                                               const float* br, const Block& bk) {
  constexpr int V = 2 * KSTEPS, XS = 16 * KSTEPS + 8;
  for (int i = threadIdx.x; i < halo_vox(N) * V; i += NTHREADS) {
    const int v = i % V, vox = i / V;
    const int gw = bk.w0 - 1 + vox % HW, gh = bk.h0 - 1 + (vox / HW) % HH;
    const int gd = bk.d0 - 1 + vox / (HW * HH);
    const int ch = c * 16 * KSTEPS + v * 8;
    if (ch >= p.Cin || gd < 0 || gd >= p.D || gh < 0 || gh >= p.H || gw < 0 || gw >= p.W)
      continue;
    uint4* ptr = reinterpret_cast<uint4*>(hb + vox * XS + v * 8);
    uint4 val = *ptr;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
    const float4* a4 = reinterpret_cast<const float4*>(ar + ch);
    const float4* b4 = reinterpret_cast<const float4*>(br + ch);
    const float4 av[2] = {a4[0], a4[1]}, bv[2] = {b4[0], b4[1]};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      const float* aj = reinterpret_cast<const float*>(&av[j / 2]) + 2 * (j % 2);
      const float* bj = reinterpret_cast<const float*>(&bv[j / 2]) + 2 * (j % 2);
      e[j] = __floats2bfloat162_rn(fmaxf(__fadd_rn(__fmul_rn(f.x, aj[0]), bj[0]), 0.0f),
                                   fmaxf(__fadd_rn(__fmul_rn(f.y, aj[1]), bj[1]), 0.0f));
    }
    *ptr = val;
  }
}

// One depth plane kd of one Cin chunk: its 9 taps, each as KSTEPS k steps
// of 16 channels. Per tap, the warp's A fragments (MT row blocks x KSTEPS)
// come by ldmatrix from the halo rows shifted by (kd, kh, kw), one address
// per row, into one of ASLOTS register slots; then the warpgroup issues the
// tap's wgmma as one group against the plane's weight stage. Up to
// ASLOTS - 1 groups stay in flight while the next tap's fragments load; the
// plane ends with every group complete.
template <int N, int KSTEPS>
__device__ __forceinline__ void plane_mma(float (&acc)[mt_of(N)][N / 2], uint32_t a_addr,
                                          int kd, int XS, uint32_t b_addr, int KC) {
  constexpr int MT = mt_of(N);
  constexpr int ASLOTS = N <= 64 ? 2 : 3;  // 2 at N <= 64: two blocks per SM
  const uint32_t mt_stride = HH * HW * XS * 2;   // row block m + 1: one depth plane on
  const uint32_t tap_bytes = KC * N * 2;
  a_addr += kd * mt_stride;
  uint32_t a[ASLOTS][KSTEPS][MT][4];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int kh = t / 3, kw = t % 3;
    uint32_t (&slot)[KSTEPS][MT][4] = a[t % ASLOTS];
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(a_addr + m * mt_stride + (kh * HW + kw) * XS * 2 + s * 32, slot[s][m]);
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      const uint64_t desc = smem_desc(b_addr + t * tap_bytes + s * 256, 128, KC * 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) Wgmma<N>::mma(acc[m], slot[s][m], desc);
    }
    wgmma_commit();
    wgmma_wait<ASLOTS - 1>();  // the group that used the next tap's slot is done
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
#pragma unroll
  for (int t = 0; t < ASLOTS; ++t)
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_regs(a[t][s][m]);
}

// K as (Cin chunk, kd) iterations j in [j0, j1): the plane's 9 taps of
// weights in one of two stages, the chunk's halo in one of two stages, each
// iteration's loads issued before the previous one's math.
template <int N, int KSTEPS>
__device__ __forceinline__ void main_loop(const Params& p, float (&acc)[mt_of(N)][N / 2],
                                          unsigned char* smem, const Block& bk, int j0, int j1,
                                          const float* arow, const float* brow) {
  constexpr int KC = 16 * KSTEPS, XS = KC + 8;
  const int hbytes = halo_bytes(KC, N), wbytes = wstage_bytes(KC, N);
  bf16* halo0 = reinterpret_cast<bf16*>(smem);
  unsigned char* wring = smem + halo_bufs(p.nchunks) * hbytes;
  const int cfirst = j0 / 3;
  const int nb = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warp w of warpgroup q owns W rows r = (q * MT + m) * 4 + w % 4, m < MT
  constexpr int MT = mt_of(N);
  const int r0 = (warp / 4) * MT * 4 + warp % 4;
  const int a_off = (((r0 / TH) * HH + r0 % TH) * HW * XS + (lane & 15) * XS + (lane >> 4) * 8) * 2;

  load_halo<N, KSTEPS>(p, halo0, cfirst, bk);
  if ((cfirst + 1) * 3 < j1) load_halo<N, KSTEPS>(p, halo0 + hbytes / 2, cfirst + 1, bk);
  load_weights<N>(p, wring, j0, nb);
  cp_async_commit();
  for (int j = j0; j < j1; ++j) {
    // iteration j's loads have landed, and every warp is done with j - 1
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int c = j / 3, kd = j % 3;
    if (j + 1 < j1) load_weights<N>(p, wring + ((j + 1 - j0) & 1) * wbytes, j + 1, nb);
    if (kd == 0 && c > cfirst && (c + 1) * 3 < j1)
      load_halo<N, KSTEPS>(p, halo0 + ((c + 1 - cfirst) & 1) * (hbytes / 2), c + 1, bk);
    cp_async_commit();
    bf16* hb = halo0 + ((c - cfirst) & 1) * (hbytes / 2);
    if (arow != nullptr && (j == j0 || kd == 0)) {
      apply_prologue<N, KSTEPS>(p, hb, c, arow, brow, bk);
      __syncthreads();
    }
    plane_mma<N, KSTEPS>(acc, smem_u32(hb) + a_off, kd, XS,
                         smem_u32(wring + ((j - j0) & 1) * wbytes), KC);
  }
}

template <int N>
__global__ void __launch_bounds__(NTHREADS, N <= 64 ? 2 : 1)
    conv3x3_gn_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int MT = mt_of(N), TDN = tile_d(N);
  const int KC = p.KC;
  const size_t rows_off = smem_bytes(KC, N, p.nchunks) - size_t(2) * p.nchunks * KC * 4;
  float* arow = reinterpret_cast<float*>(smem + rows_off);
  float* brow = arow + p.nchunks * KC;

  Block bk;
  long long t = blockIdx.x;
  bk.w0 = int(t % p.tiles_w) * TW;
  t /= p.tiles_w;
  bk.h0 = int(t % p.tiles_h) * TH;
  t /= p.tiles_h;
  bk.d0 = int(t % p.tiles_d) * TDN;
  bk.bi = t / p.tiles_d;
  const int nb = blockIdx.y, sp = blockIdx.z;
  const int iters = p.nchunks * 3;  // (chunk, kd) planes
  const int j0 = int((long long)iters * sp / p.split);
  const int j1 = int((long long)iters * (sp + 1) / p.split);

  const bool prologue = p.a != nullptr;
  if (prologue)
    for (int c = threadIdx.x; c < p.nchunks * KC; c += NTHREADS) {
      arow[c] = c < p.Cin ? p.a[bk.bi * p.Cin + c] : 0.0f;
      brow[c] = c < p.Cin ? p.b[bk.bi * p.Cin + c] : 0.0f;
    }
  const float* ar = prologue ? arow : nullptr;

  float acc[MT][N / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.0f;

  switch (KC / 16) {
    case 1: main_loop<N, 1>(p, acc, smem, bk, j0, j1, ar, brow); break;
    case 2: main_loop<N, 2>(p, acc, smem, bk, j0, j1, ar, brow); break;
    case 3: main_loop<N, 3>(p, acc, smem, bk, j0, j1, ar, brow); break;
    default: main_loop<N, 4>(p, acc, smem, bk, j0, j1, ar, brow); break;
  }

  // ---- epilogue: stage, add residual in f32, write bf16 (or f32 partials) --
  cp_async_wait<0>();
  __syncthreads();
  constexpr int OS = N + 4;
  constexpr int M_TILE = M_BASE * MT;
  float* os = reinterpret_cast<float*>(smem);
  {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = ((warp / 4) * MT + m) * 4 + warp % 4;  // W row of the tile
      float* r0 = os + (r * 16 + g) * OS + 2 * t4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        *reinterpret_cast<float2*>(r0 + 8 * j) = make_float2(acc[m][4 * j], acc[m][4 * j + 1]);
        *reinterpret_cast<float2*>(r0 + 8 * OS + 8 * j) =
            make_float2(acc[m][4 * j + 2], acc[m][4 * j + 3]);
      }
    }
  }
  __syncthreads();
  const long long nvox = (long long)p.B * p.D * p.H * p.W;
  for (int i = threadIdx.x; i < M_TILE * (N / 8); i += NTHREADS) {
    const int v = i % (N / 8), m = i / (N / 8);
    const int gd = bk.d0 + m / (TW * TH), gh = bk.h0 + (m / TW) % TH, gw = bk.w0 + m % TW;
    const int n = nb * N + v * 8;
    if (gd >= p.D || gh >= p.H || gw >= p.W || n >= p.Cout) continue;
    const long long vox = ((bk.bi * p.D + gd) * p.H + gh) * (long long)p.W + gw;
    const float* src = os + m * OS + v * 8;
    if (p.split > 1) {
      float4* dst = reinterpret_cast<float4*>(p.ws + (sp * nvox + vox) * p.Cout + n);
      dst[0] = make_float4(src[0], src[1], src[2], src[3]);
      dst[1] = make_float4(src[4], src[5], src[6], src[7]);
      continue;
    }
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = src[j];
    if (p.res != nullptr) {
      const uint4 rv = *reinterpret_cast<const uint4*>(p.res + vox * p.Cout + n);
      const bf16* e = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] += __bfloat162float(e[j]);
    }
    uint4 o;
    bf16* e = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(r[j]);
    *reinterpret_cast<uint4*>(p.out + vox * p.Cout + n) = o;
  }
}

// Split-K: out = bf16(((p_0 + p_1) + ...) + f32(res)), partials in split order.
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, const bf16* __restrict__ res,
                     bf16* __restrict__ out, long long nvec, long long stride, int split) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < nvec; i += (long long)gridDim.x * 256) {
    float r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = 0.0f;
    for (int s = 0; s < split; ++s) {
      const float4* src = reinterpret_cast<const float4*>(ws + s * stride + i * 8);
      const float4 lo = src[0], hi = src[1];
      r[0] += lo.x; r[1] += lo.y; r[2] += lo.z; r[3] += lo.w;
      r[4] += hi.x; r[5] += hi.y; r[6] += hi.z; r[7] += hi.w;
    }
    if (res != nullptr) {
      const uint4 rv = *reinterpret_cast<const uint4*>(res + i * 8);
      const bf16* e = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] += __bfloat162float(e[j]);
    }
    uint4 o;
    bf16* e = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(r[j]);
    *reinterpret_cast<uint4*>(out + i * 8) = o;
  }
}

template <int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.KC, N, p.nchunks);
  if (smem > size_t(MAX_SMEM)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_gn_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const long long nblocks = (long long)p.B * p.tiles_d * p.tiles_h * p.tiles_w;
  if (nblocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  conv3x3_gn_kernel<N><<<dim3(unsigned(nblocks), p.nblocks, p.split), NTHREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.split == 1) return err;
  const long long nvox = (long long)p.B * p.D * p.H * p.W;
  const long long nvec = nvox * p.Cout / 8;
  const long long grid = (nvec + 255) / 256 < 132 * 16 ? (nvec + 255) / 256 : 132 * 16;
  splitk_reduce_kernel<<<unsigned(grid), 256, 0, stream>>>(p.ws, p.res, p.out, nvec,
                                                           nvox * p.Cout, p.split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int: 0 when the launches were accepted. a and b
// are both null (prologue off) or both set; res may be null. w is packed by
// ops/conv3x3.py::pack_weight for (KC, N); workspace holds split * B * D * H *
// W * Cout f32 when split > 1 (may be null otherwise). One call launches the
// conv kernel, and the split-K reduction when split > 1.
int conv3x3_gn_bf16(const void* x, const void* w, const void* a, const void* b,
                    const void* res, void* out, void* workspace, int B, int D, int H, int W,
                    int Cin, int Cout, int KC, int N, int split, void* stream) {
  if (Cin % 8 != 0 || Cout % 8 != 0 || B < 1 || D < 1 || H < 1 || W < 1)
    return int(cudaErrorInvalidValue);
  if ((a == nullptr) != (b == nullptr)) return int(cudaErrorInvalidValue);
  if (KC % 16 != 0 || KC < 16 || KC > 64 || split < 1 || split > 65535 ||
      (split > 1 && workspace == nullptr))
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.ws = static_cast<float*>(workspace);
  p.B = B; p.D = D; p.H = H; p.W = W;
  p.Cin = Cin; p.Cout = Cout; p.KC = KC;
  p.nchunks = (Cin + KC - 1) / KC;
  p.nblocks = (Cout + N - 1) / N;
  p.split = split;
  p.tiles_d = (D + tile_d(N) - 1) / tile_d(N);
  p.tiles_h = (H + TH - 1) / TH;
  p.tiles_w = (W + TW - 1) / TW;
  if (split > p.nchunks * 3) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 16: err = launch<16>(p, s); break;
    case 24: err = launch<24>(p, s); break;
    case 32: err = launch<32>(p, s); break;
    case 48: err = launch<48>(p, s); break;
    case 64: err = launch<64>(p, s); break;
    case 96: err = launch<96>(p, s); break;
    case 128: err = launch<128>(p, s); break;
    case 192: err = launch<192>(p, s); break;
    case 256: err = launch<256>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return int(err);
}

const char* conv3x3_gn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
