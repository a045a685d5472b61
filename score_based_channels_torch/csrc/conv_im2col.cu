// k x k dilated "same" convolution as one implicit GEMM over the live taps.
//
// Replaces the JAX package's kernels/conv_probe.py::conv_im2col (:135, its
// pallas_call at :169): the Pallas kernel materialises the (S*B, T*Cin)
// patch of the T live taps (shifted, masked, zero where a tap leaves the
// image) in VMEM and does one (S*B, T*Cin) x (T*Cin, Cout) dot with f32
// accumulation, then + bias, optional ELU and one rounding to x's dtype.
//
// Here the GEMM has M = B*H*W rows (pixels), K = T*Cin (live taps only,
// packed (tap, channel) columns) and N = Cout. A block owns an M x N tile
// of the output. It never holds the whole patch: it builds its rows of the
// patch in shared memory one K-chunk at a time, shifted and masked as the
// Pallas kernel does, beside the matching rows of the weight, and
// accumulates the chunk's product in registers. The weight is read in
// place from the (k, k, Cin, Cout) memory of the tensor (the module's
// (Cout, Cin, k, k) parameter in kernels/conv.py::kernel_layout): packed
// column (t, c) is row wi * Cin + c of it, wi = iy * k + ix, so no packed
// copy of the weight exists that could go stale. Dead taps
// (kernels/conv.py::live_taps) are never visited.
//
// Layouts: x and out are addressed as (batch, row, column, channel) with
// the channel innermost (stride 1) and the other three strides given, so
// one kernel serves the probe's (S = H*W, B, C) layout and the model's NCHW
// tensors in torch.channels_last. The bias is (Cout,), f32 or x's type, or
// NULL.
//
// Bound on an H100: a 3x3 conv does ~4.5*Cin operations per byte of bf16
// activation, below the ~295 where the tensor cores rather than the memory
// become the limit, so at the main path's shapes the bytes bound it (one
// NCSNv2-Deepest forward at batch 256: ~1.2 GB of bf16 activations,
// >= 0.35 ms; its ~203 GFLOP take >= 0.21 ms on the bf16 tensor cores and
// >= 3 ms on the FP32 FMA units). Two routes:
//
//  - bf16 (any channel counts): the tensor cores, wgmma m64nNk16 with both
//    operands read from shared memory through descriptors. The kernel is
//    persistent, on the output tiles of conv2d_taps (SB samples x TH whole
//    rows x W, 64 or 128 pixels: one or two consumer warpgroups; BN output
//    channels per block, so the 8x2 layers run 128 blocks at batch 256).
//    A block loads the weight rows of its channels for every stage of a
//    tile once, and they stay resident. A tile's K (the packed (tap,
//    channel) columns of its patch) arrives in stages through a ring of
//    four mbarrier-guarded slots:
//      - Cin % 8 == 0: a stage is one (tap, chunk of up to 64 channels),
//        one TMA box of the tap's shifted pixels (chunk, W, TH, SB) from
//        (c0, dx, h0 + dy, b0), zero outside the tensor (the conv's
//        padding), in swizzled rows that wgmma reads directly; weights
//        likewise by TMA boxes of up to 64 channels. This is TMA's tiled
//        mode with the tap's offsets in the coordinates, which does what
//        its im2col mode would for one tap; the patch never exists outside
//        shared memory.
//      - otherwise (the 2-channel begin conv; odd counts; x unaligned): a
//        stage is 64 packed columns, which may span taps (the
//        begin conv is one stage of 18 live columns), gathered by four
//        producer warps with 4-byte cp.async (Cin even; zero-filled where a
//        tap leaves the image) or plain loads into the same swizzled rows.
//    The 2-channel end conv is an N = 8 tile. Every pixel is read from L2
//    once per live tap: the im2col product's cost against conv2d_taps,
//    which reads it once per channel chunk.
//  - float32: the FP32 FMA units, where the operations bound it (the JAX
//    package's f32 bar of 1e-5 of max|ref| rules out TF32), unchanged from
//    the first port. Each of the
//    256 threads keeps a 4-row x 4-channel f32 output tile in registers
//    and reads one 16-byte vector of the patch stage and one of the weight
//    stage for every 16 FMAs; Cout <= 32 takes a 128 x 32 tile and wider
//    outputs a 64 x 64 tile, so narrow layers waste no columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <string.h>

#include "conv_sm90.cuh"

namespace {

using conv_sm90::kMaxTaps;
constexpr int NT = 256;  // threads per block
constexpr int BK = 16;   // K columns (tap, input channel) per stage
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output channels per thread

using Taps = conv_sm90::TapTable;

// four consecutive elements; p is aligned to four elements
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
// up to four consecutive elements, those at or past `valid` read as 0
__device__ __forceinline__ float4 load4_masked(const float* p, int valid,
                                               int vec) {
  if (valid >= 4 && vec) return load4(p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = p[0];
  if (valid > 1) v.y = p[1];
  if (valid > 2) v.z = p[2];
  if (valid > 3) v.w = p[3];
  return v;
}

// BN output channels per block; BM = NT*TM*TN/BN output rows (128 for
// BN = 32, 64 for BN = 64)
template <int BN>
__global__ void __launch_bounds__(NT)
    conv_im2col_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ out, int B, int H, int W, int Cin,
                       int Cout, long long xs_b, long long xs_h,
                       long long xs_w, long long os_b, long long os_h,
                       long long os_w, Taps taps, int elu, int vec_x,
                       int vec_w, int vec_o) {
  constexpr int BM = NT * TM * TN / BN;
  constexpr int AP = BM + 4;     // padded stage row: 16-byte aligned reads
  constexpr int NQ = BN / TN;    // thread columns of the output tile
  constexpr int RPT = BM / 64;   // patch rows each thread stages
  constexpr int BV = BK * BN / 4;  // four-wide weight vectors per stage
  __shared__ __align__(16) float a_s[BK * AP];  // patch stage [k][m]
  __shared__ __align__(16) float b_s[BK * BN];  // weight stage [k][n]

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int M = B * HW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the patch rows this thread stages: m0 + tid/4 + 64*p, four channels
  // (4*q .. 4*q+3) of each K-chunk
  const int q = tid & 3;
  int rh[RPT], rw[RPT];
  long long roff[RPT];
  bool rok[RPT];
#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    const int m = m0 + tid / 4 + 64 * p;
    rok[p] = m < M;
    const int mm = rok[p] ? m : 0;
    const int b = mm / HW, rem = mm % HW;
    rh[p] = rem / W;
    rw[p] = rem % W;
    roff[p] = b * xs_b + rh[p] * xs_h + rw[p] * xs_w;
  }

  const int tx = tid % NQ, ty = tid / NQ;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < taps.n; ++t) {
    const int dy = taps.dy[t], dx = taps.dx[t];
    const float* wt = w + (size_t)taps.wi[t] * Cin * Cout;
    long long src[RPT];
    bool ok[RPT];
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
      const int hh = rh[p] + dy, ww = rw[p] + dx;
      ok[p] = rok[p] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      src[p] = roff[p] + dy * xs_h + dx * xs_w;
    }
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      __syncthreads();  // the previous stage has been consumed
      const int c = c0 + 4 * q;
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok[p]) v = load4_masked(x + src[p] + c, Cin - c, vec_x);
        const int r = tid / 4 + 64 * p;
        a_s[(4 * q + 0) * AP + r] = v.x;
        a_s[(4 * q + 1) * AP + r] = v.y;
        a_s[(4 * q + 2) * AP + r] = v.z;
        a_s[(4 * q + 3) * AP + r] = v.w;
      }
      if (tid < BV) {
        const int kr = tid / (BN / 4), col = (tid % (BN / 4)) * 4;
        const int cc = c0 + kr, n = n0 + col;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (cc < Cin) v = load4_masked(wt + (size_t)cc * Cout + n, Cout - n,
                                       vec_w);
        *reinterpret_cast<float4*>(&b_s[kr * BN + col]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a =
            *reinterpret_cast<const float4*>(&a_s[k * AP + ty * TM]);
        const float4 bv =
            *reinterpret_cast<const float4*>(&b_s[k * BN + tx * TN]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bw[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      }
    }
  }

  // epilogue: + bias, ELU, one rounding to the output type
  const int n = n0 + tx * TN;
  if (n >= Cout) return;
  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    bv[j] = bias != nullptr && n + j < Cout ? bias[n + j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int b = m / HW, rem = m % HW;
    float* o = out + b * os_b + (rem / W) * os_h + (rem % W) * os_w + n;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      v[j] = acc[i][j] + bv[j];
      if (elu) v[j] = v[j] > 0.f ? v[j] : expm1f(v[j]);
    }
    if (vec_o && n + TN <= Cout) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < Cout) o[j] = v[j];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma
// ---------------------------------------------------------------------------

using conv_sm90::kMaxWG;
using conv_sm90::Tile;
using bf16 = __nv_bfloat16;

// Shared-memory layout of one block, the same as
// kernels/conv_im2col.py::plan computes: the ring of `stages` patch
// stages (BM rows of RB bytes, swizzled), the weight slices of every stage
// of a tile for the block's BN channels, the staging rows, the barriers.
struct Im2colLayout {
  int AS;       // bytes of one patch stage: BM x RB
  int WS;       // bytes of one weight slice: KW x BN bf16
  int w_off, st_off, bar_off, bytes;
  __host__ __device__ Im2colLayout(int BM, int RB, int BN, int slices,
                                   int stages) {
    AS = BM * RB;
    WS = RB * BN;  // KW = RB / 2 rows of BN bf16
    w_off = stages * AS;
    st_off = w_off + slices * WS;
    bar_off = st_off + BM * (BN + 8) * 2;
    bytes = bar_off + (2 * stages + slices) * 8 + 1024;  // + alignment slack
  }
};

// Warps 0 .. 4*nwg-1 are the consumer warpgroups, the warps after them the
// producers (one for TMA boxes, four for copied stages). The block owns
// output channels n0 = blockIdx.y * BN .. and the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...; a tile's K is its stages:
//  - a_mode 2 (Cin % 8 == 0): stage (chunk c, tap t) is one TMA box of the
//    tap's shifted pixels, (Kc, W, TH, SB) from (c Kc, dx, h0 + dy, b0),
//    zero outside the tensor, in rows of RB = 2 Kc bytes;
//  - otherwise: stage s is the packed (tap, channel) columns 64 s .. of the
//    patch, which may span taps, copied by the producer warps in 4-byte
//    cp.async pieces (a_mode 1, Cin even) or plain loads (a_mode 0) into
//    128-byte rows swizzled as TMA would.
// use_wmap: weight slices by TMA (TMA boxes with Cout % 8 == 0), else
// plain loads.
template <int BN, int KS>
__global__ void __launch_bounds__(kMaxWG * 128 + 128)
    conv_im2col_wgmma_kernel(
        const __grid_constant__ CUtensorMap xmap,
        const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ x,
        const bf16* __restrict__ w, const void* __restrict__ bias,
        int bias_bf16, bf16* __restrict__ out, int B, int H, int W, int Cin,
        int Cout, long long xs_b, long long xs_h, long long xs_w,
        long long os_b, long long os_h, long long os_w, int SB, int TH,
        int nwg, int stages, Taps taps, int elu, int a_mode,
        int use_wmap, int o_vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ int s_dy[kMaxTaps], s_dx[kMaxTaps], s_wi[kMaxTaps];
  const int T = taps.n, K = T * Cin;
  const bool boxes = a_mode == 2;
  const int KW = 16 * KS;  // K columns per stage (packed stages: KS = 4)
  const int RB = 2 * KW;
  const int nchunks = (Cin + KW - 1) / KW;
  const int slices = boxes ? nchunks * T : (K + KW - 1) / KW;
  const int BM = 64 * nwg;
  const Im2colLayout L(BM, RB, BN, slices, stages);
  uint8_t* wts = base + L.w_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bar_off);
  uint64_t* afull = bars;             // [stages] a patch stage has landed
  uint64_t* aempty = bars + stages;   // [stages] ... and has been read out
  uint64_t* wfull = bars + 2 * stages;  // [slices] a weight slice has landed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int consumers = 4 * nwg;
  const int nprod = (int)blockDim.x / 32 - consumers;  // producer warps
  const int n0 = blockIdx.y * BN;
  const int tiles = (H + TH - 1) / TH * ((B + SB - 1) / SB);
  const int tile_px = TH * W, P = SB * tile_px;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      s_dy[i] = taps.dy[i];
      s_dx[i] = taps.dx[i];
      s_wi[i] = taps.wi[i];
    }
    for (int i = 0; i < stages; ++i) {
      sm90::mbar_init(&afull[i], nprod);
      sm90::mbar_init(&aempty[i], consumers);
    }
    for (int i = 0; i < slices; ++i) sm90::mbar_init(&wfull[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= consumers) {
    // ---- producer warps ----
    const int pw = warp - consumers;  // this producer warp
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
    // patch stage g of the block's sequence: slice i of tile mt
    auto load_stage = [&](int g, int mt, int i) {
      const int slot = g % stages;
      if (g >= stages) sm90::mbar_wait(&aempty[slot], ((g / stages) - 1) & 1);
      uint8_t* dst = base + slot * L.AS;
      const Tile tile(mt, H, TH, SB);
      if (boxes) {  // one producer warp
        if (lane == 0) {
          const int c = i / T, t = i % T;
          sm90::mbar_arrive_expect_tx(&afull[slot], P * RB);
          sm90::tma_load_4d(dst, &xmap, &afull[slot], c * KW, s_dx[t],
                            tile.h0 + s_dy[t], tile.b0);
        }
        return;
      }
      // columns past K stay zero once written: a slot's first fill writes
      // every piece, later ones only the pieces with columns
      const int pieces =
          g < stages ? 8 : (K - i * 64 + 7) / 8 < 8 ? (K - i * 64 + 7) / 8 : 8;
      for (int id = pw * 32 + lane; id < P * pieces; id += 32 * nprod) {
        const int q = id % pieces, p = id / pieces;
        const int rem = p % tile_px;
        const int b = tile.b0 + p / tile_px, h = tile.h0 + rem / W;
        const int wc = rem % W;
        const int k0 = i * 64 + 8 * q;
        uint8_t* d = dst + sm90::swizzle(p * 128 + 16 * q, 128);
        // element e of the piece: packed column k0 + e = (tap, channel)
        auto src = [&](int e, bool& ok) -> long long {
          const int kk = k0 + e, t = kk / Cin, c = kk - t * Cin;
          ok = kk < K && b < B && h < H;
          if (!ok) return 0;
          const int hh = h + s_dy[t], ww = wc + s_dx[t];
          ok = hh >= 0 && hh < H && ww >= 0 && ww < W;
          return b * xs_b + hh * xs_h + ww * xs_w + c;
        };
        if (a_mode == 1) {  // pairs of columns, each in one tap
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (g >= stages && k0 + 2 * e >= K) break;
            bool ok;
            const long long o = src(2 * e, ok);
            sm90::cp_async4(d + 4 * e, ok ? xs + o : xs, ok ? 4 : 0);
          }
        } else {
          uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            bool ok;
            const long long o = src(e, ok);
            if (ok) v[e >> 1] |= (uint32_t)xs[o] << (16 * (e & 1));
          }
          *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      if (a_mode != 0) sm90::cp_async_arrive(&afull[slot]);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&afull[slot]);
    };
    int g = 0;
    if ((int)blockIdx.x < tiles) load_stage(g++, blockIdx.x, 0);
    // every slice of the weight once (the first producer warp): column k
    // of slice i is weight row wi * Cin + channel of its (tap, channel)
    for (int i = 0; i < slices && pw == 0; ++i) {
      const int c = i / T, t = i % T;
      conv_sm90::load_weight_slice(
          wts + i * L.WS, use_wmap ? &wmap : nullptr, w,
          s_wi[t] * Cin + c * KW, KW, BN, n0, Cout,
          [&](int k) {
            if (boxes)
              return c * KW + k < Cin ? s_wi[t] * Cin + c * KW + k : -1;
            const int kk = i * KW + k, tt = kk / Cin;
            return kk < K ? s_wi[tt] * Cin + kk - tt * Cin : -1;
          },
          &wfull[i], lane);
    }
    for (int mt = blockIdx.x; mt < tiles; mt += gridDim.x)
      for (int i = (mt == (int)blockIdx.x); i < slices; ++i)
        load_stage(g++, mt, i);
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = warp >> 2;
  bf16* st = reinterpret_cast<bf16*>(base + L.st_off) + wg * 64 * (BN + 8);
  const int wrb = conv_sm90::weight_row_bytes(BN);
  float acc[BN / 2];
  int g = 0;  // the block's stage sequence
  for (int mt = blockIdx.x; mt < tiles; mt += gridDim.x) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    sm90::fence_acc<BN / 2>(acc);
    for (int i = 0; i < slices; ++i, ++g) {
      const int slot = g % stages;
      sm90::mbar_wait(&afull[slot], (g / stages) & 1);
      sm90::mbar_wait(&wfull[i], 0);
      if (!boxes) sm90::fence_proxy_async();  // copies, before wgmma reads
      sm90::wgmma_fence();
      const uint8_t* a = base + slot * L.AS + wg * 64 * RB;
      const uint8_t* wb = wts + i * L.WS;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
          sm90::Wgmma<BN>::ss(acc, sm90::desc_swizzled(a + 32 * ks, RB),
                              sm90::desc_nmajor(wb + ks * 16 * wrb, wrb,
                                                KW * wrb));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the stage before has been read out
      if (i > 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&aempty[(g - 1) % stages]);
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc<BN / 2>(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&aempty[(g - 1) % stages]);
    conv_sm90::store_tile<BN>(acc, st, wg, bias, bias_bf16, elu, out, os_b,
                              os_h, os_w, n0, Cout, Tile(mt, H, TH, SB), B,
                              H, W, TH, P, o_vec);
  }
}

template <int BN, int KS>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap,
                         const void* x, const void* w, const void* bias,
                         int bias_bf16, void* out, int B, int H, int W,
                         int Cin, int Cout, long long xs_b, long long xs_h,
                         long long xs_w, long long os_b, long long os_h,
                         long long os_w, int SB, int TH, int nwg,
                         int stages, const Taps& taps, int elu,
                         int a_mode, int use_wmap, int o_vec, int smem,
                         cudaStream_t s) {
  auto kernel = conv_im2col_wgmma_kernel<BN, KS>;
  static int smem_set = 0;  // the opt-in limit set so far
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const int threads = nwg * 128 + (a_mode == 2 ? 32 : 128);
  const int tiles = (H + TH - 1) / TH * ((B + SB - 1) / SB);
  const int ntiles = (Cout + BN - 1) / BN;
  const dim3 grid(
      conv_sm90::persistent_blocks(reinterpret_cast<const void*>(kernel),
                                   threads, smem, tiles, ntiles),
      ntiles);
  kernel<<<grid, threads, smem, s>>>(
      xmap, wmap, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      bias, bias_bf16, static_cast<bf16*>(out), B, H, W, Cin, Cout, xs_b,
      xs_h, xs_w, os_b, os_h, os_w, SB, TH, nwg, stages, taps, elu, a_mode,
      use_wmap, o_vec);
  return cudaGetLastError();
}

// the float32 FMA kernel: block_n 32 (128 x 32 tiles) or 64 (64 x 64)
cudaError_t launch_fma(int block_n, const float* x, const float* w,
                       const float* bias, float* out, int B, int H, int W,
                       int Cin, int Cout, long long xs_b, long long xs_h,
                       long long xs_w, long long os_b, long long os_h,
                       long long os_w, const Taps& taps, int elu, int vec_x,
                       int vec_w, int vec_o, cudaStream_t s) {
  const long long M = (long long)B * H * W;
  if (block_n == 32) {
    const dim3 grid((unsigned)((M + 127) / 128), (Cout + 31) / 32);
    conv_im2col_kernel<32><<<grid, NT, 0, s>>>(
        x, w, bias, out, B, H, W, Cin, Cout, xs_b, xs_h, xs_w, os_b, os_h,
        os_w, taps, elu, vec_x, vec_w, vec_o);
  } else if (block_n == 64) {
    const dim3 grid((unsigned)((M + 63) / 64), (Cout + 63) / 64);
    conv_im2col_kernel<64><<<grid, NT, 0, s>>>(
        x, w, bias, out, B, H, W, Cin, Cout, xs_b, xs_h, xs_w, os_b, os_h,
        os_w, taps, elu, vec_x, vec_w, vec_o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// route 1: the bf16 wgmma kernel, with the plan of
// kernels/conv_im2col.py::plan (block_n = BN; SB, TH, KS, nwg, stages;
// smem_bytes bounds the layout of either stage form); the patch comes by
// TMA boxes when Cin, x's address and strides are multiples of 8
// elements, else by the producer warps' copies. The tensor maps are made
// here at every launch. route 0: the float32 FMA kernel (block_n 32 or
// 64; vec_* its four-wide accesses; the bias f32).
extern "C" int sbc_conv_im2col(
    const void* x, const void* w, const void* bias, void* out, int B, int H,
    int W, int Cin, int Cout, long long xs_b, long long xs_h, long long xs_w,
    long long os_b, long long os_h, long long os_w, int ntaps, const int* dy,
    const int* dx, const int* wi, int k, int route, int block_n, int elu,
    int bf16_in, int bias_bf16, int vec_x, int vec_w, int vec_o, int SB,
    int TH, int KS, int nwg, int stages, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route != 1) {
    if (bf16_in || bias_bf16) return (int)cudaErrorInvalidValue;
    Taps taps;
    if (!conv_sm90::make_taps(&taps, ntaps, dy, dx, wi))
      return (int)cudaErrorInvalidValue;
    return (int)launch_fma(
        block_n, static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), B, H, W,
        Cin, Cout, xs_b, xs_h, xs_w, os_b, os_h, os_w, taps, elu, vec_x,
        vec_w, vec_o, s);
  }
  if (!bf16_in || nwg < 1 || nwg > kMaxWG || SB * TH * W > 64 * nwg ||
      (KS != 1 && KS != 2 && KS != 4) || stages < 2)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  if (!conv_sm90::make_taps(&taps, ntaps, dy, dx, wi))
    return (int)cudaErrorInvalidValue;
  // TMA boxes need x's pixels in 16-byte aligned rows: Cin, the strides
  // and x's address multiples of 8 elements; a map TMA should take that
  // the CUDA driver refuses is an error, not a slower form
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const bool x16 = Cin % 8 == 0 && xa % 16 == 0 && xs_b % 8 == 0 &&
                   xs_h % 8 == 0 && xs_w % 8 == 0;
  const bool x4 = Cin % 2 == 0 && xa % 4 == 0 && xs_b % 2 == 0 &&
                  xs_h % 2 == 0 && xs_w % 2 == 0;
  const int a_mode = x16 ? 2 : x4 ? 1 : 0;
  const int Kc = 16 * KS;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  if (a_mode == 2) {  // TMA boxes of the tap's shifted pixels
    const uint64_t dims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H,
                              (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)xs_w * 2, (uint64_t)xs_h * 2,
                                 (uint64_t)xs_b * 2};
    const uint32_t box[4] = {(uint32_t)Kc, (uint32_t)W, (uint32_t)TH,
                             (uint32_t)SB};
    if (!sm90::make_map(&xmap, x, 4, dims, strides, box,
                        sm90::swizzle_mode(2 * Kc)))
      return (int)cudaErrorNotSupported;
  }
  // packed stages span taps, so their weight rows are gathered
  const int use_wmap = a_mode == 2 && conv_sm90::weight_takes_tma(w, Cout);
  if (use_wmap &&
      !conv_sm90::make_weight_map(&wmap, w, k * k * Cin, Cout, Kc, block_n))
    return (int)cudaErrorNotSupported;
  const int KW = a_mode == 2 ? Kc : 64;
  const int slices = a_mode == 2 ? (Cin + KW - 1) / KW * ntaps
                                 : (ntaps * Cin + KW - 1) / KW;
  const Im2colLayout L(64 * nwg, 2 * KW, block_n, slices, stages);
  if (smem_bytes < L.bytes) return (int)cudaErrorInvalidValue;
  const int ks = a_mode == 2 ? KS : 4;
#define SBC_IM2COL_LAUNCH(N, S)                                             \
  return (int)launch_wgmma<N, S>(xmap, wmap, x, w, bias, bias_bf16, out, B, \
                                 H, W, Cin, Cout, xs_b, xs_h, xs_w, os_b,   \
                                 os_h, os_w, SB, TH, nwg, stages, taps, elu, \
                                 a_mode, use_wmap, vec_o, L.bytes, s)
#define SBC_IM2COL_KS(N)             \
  switch (ks) {                      \
    case 1: SBC_IM2COL_LAUNCH(N, 1); \
    case 2: SBC_IM2COL_LAUNCH(N, 2); \
    case 4: SBC_IM2COL_LAUNCH(N, 4); \
  }                                  \
  break
  switch (block_n) {
    case 8: SBC_IM2COL_KS(8);
    case 16: SBC_IM2COL_KS(16);
    case 32: SBC_IM2COL_KS(32);
    case 64: SBC_IM2COL_KS(64);
    case 128: SBC_IM2COL_KS(128);
  }
#undef SBC_IM2COL_KS
#undef SBC_IM2COL_LAUNCH
  return (int)cudaErrorInvalidValue;
}
