// k x k dilated convolution over the live taps, channels-last, stride 1.
//
// Replaces the JAX package's kernels/conv_probe.py::conv_pertap (:105, the
// Pallas per-tap conv: a sum over the live taps of shifted, masked
// (S*B, Cin) x (Cin, Cout) products with f32 accumulation and an optional
// bias + ELU epilogue). It computes the function of every Conv2d of the
// NCSNv2-Deepest forward (models/layers.py Conv2d with dead-tap pruning).
//
// Layouts: x and out are (B, H, W, C) in memory (PyTorch NCHW tensors in
// torch.channels_last); the weight is the module's (Cout, Cin, k, k)
// parameter, laid out in memory as (k*k, Cin, Cout), one (Cin, Cout) matrix
// per tap, in the activation dtype; the kernels read the live taps only, by
// their index wi = iy*k + ix. The bias is (Cout,), f32 or x's dtype, or NULL.
//
// Bound on an H100: at batch 256 the convs of one forward are ~203 GFLOP
// (>= 0.21 ms on the bf16 tensor cores) and move ~1.2 GB of bf16
// activations (>= 0.35 ms at 3.35 TB/s), so in bf16 the bytes bound them;
// on the FP32 FMA units the operations alone take >= 3 ms. Two routes:
//
//  - bf16: the tensor cores (wgmma), following the Pallas kernel's idea of
//    keeping the activation tile resident and applying every tap to it.
//    The kernel is persistent: a block owns BN output channels and walks
//    over output tiles (SB samples x TH whole rows x W, at most 64 or 128
//    pixels: one or two consumer warpgroups), as many blocks as the card
//    holds at once (conv_sm90.cuh). Its producer warp loads, by TMA:
//      - once, every (input-channel chunk, live tap) weight slice of its
//        channels, from a 2-D map over the (k*k*Cin, Cout) memory in boxes
//        of up to 64 channels (rows of up to 128 bytes, swizzled) into an
//        N-major tile that stays resident; wgmma reads it through the
//        transpose bit, so the weight is never copied in another layout;
//      - per (tile, chunk of up to 64 input channels), one box of the tile
//        with its halo, (chunk, W + 2px, TH + 2py, SB) from (c0, -px,
//        h0 - py, b0), into a ring of two buffers, so the next tile's halo
//        lands while this one is multiplied and stored. TMA zero-fills
//        what lies outside the tensor, which is the conv's padding, so no
//        bounds test remains; its 32/64/128-byte swizzle keeps the
//        gathers below free of bank conflicts.
//    Per live tap, every lane of a consumer warpgroup gives ldmatrix the
//    row of its pixel's shifted position in the halo tile (the shift costs
//    nothing) and the warpgroup issues wgmma with A from those registers
//    and B (the tap's weights) from shared memory; two sets of A registers
//    let one tap's product run while the next tap's rows are gathered. The
//    activation is read from memory once per channel chunk, where an im2col
//    product reads it once per tap. For x with Cin not a multiple of 8 (the
//    2-channel begin conv: a TMA row stride must be a multiple of 16 bytes)
//    the producer writes the same halo rows by 4-byte cp.async (Cin even)
//    or plain loads, and for a weight with Cout not a multiple of 8 (the
//    2-channel end conv, an N = 8 tile) the same slices by plain loads,
//    zero-padded to 16 input and 8 output channels. Epilogue: + bias, ELU,
//    one rounding to bf16, staged in shared memory, stored in 16-byte
//    pieces. The weight boxes are 64 channels wide because TMA moves a box
//    row by row: N-major core matrices of 8 channels (16-byte rows) would
//    stream the weights 16 bytes per request.
//  - float32: the FP32 FMA units, IEEE f32 products and sums (the JAX
//    package's f32 bar of 1e-5 of max|ref| and the recipes' full-f32
//    training rule out TF32). Operations bound it: >= 3.066 ms per forward
//    at batch 256 and >= 0.382 ms of dgrad per training step at batch 32,
//    at 67 TFLOP/s. It is an implicit GEMM: M = output pixels, N = output
//    channels, K = live taps x input channels.
//      - Register tile: a block owns BM pixels (SB samples x TH whole rows
//        x W) x BN <= 32 channels; a thread owns 8 pixels x 4 channels, so
//        per 4 input channels 12 16-byte shared loads (a pixel's 4
//        channels, 8 times; 4 weights, 4 times) feed 128 FMAs. Lanes of a
//        warp that share pixels read the same address (a broadcast); the
//        pixels a warp reads at once are neighbours in the halo, whose
//        pixel pitch BK + 4 floats (an odd number of 16-byte units) puts
//        them in distinct banks; a weight row is read in one 128-byte run.
//        An 8 x 8 tile (BN 64, 128) needed 205-211 registers, so one
//        256-thread block an SM, and was measured no faster: the plan keeps
//        BN <= 32, as many channel tiles as Cout needs.
//      - Staging: a stage is one chunk of BK input channels: the halo tile
//        ((SB, TH + 2py, W + 2px) pixels, zero outside the image: the
//        conv's padding) and the chunk's rows of every live tap's weights
//        (T, BK, BN). The stages cycle through a ring of 2-4 in dynamic
//        shared memory (opted in up to 227 KB) filled by 16-byte cp.async
//        (4-byte where Cin or Cout is not a multiple of 4, by plan), so
//        chunk c + 1 lands while chunk c is multiplied, with one barrier a
//        chunk; every tap reads the chunk's one halo tile at its shift.
//        The source offsets of the halo's pixels are computed once a block
//        (no division in the copy loop).
//      - Split K: where the output tiles are too few to fill the card (the
//        8x2 to 32x8 layers at batch 32, 8x2 at batch 256) a thread-block
//        cluster of CL = 2, 4 or 8 blocks shares a tile, each block taking
//        a contiguous range of the chunks. Every block leaves its partial
//        tile in its shared memory, and each sums 1/CL of the tile over
//        the cluster's blocks in rank order through distributed shared
//        memory: no atomics, so two launches give equal bits. Then + bias,
//        ELU (expm1f), one store.
//      - The weight is read in place (kernel_layout); a block reads only
//        its chunks of its BN channels, once.
//      - Wide route (the kernel's SEG instance): layers of up to 512
//        channels and rows of up to 256 pixels (NCSNv2-Deepest's training
//        at its FFHQ widths) take tiles of TH rows of a segment of WS
//        columns (WS dividing W), so a wide row's halo stays small; more
//        channels are more channel tiles and more chunks. The arithmetic
//        and the fixed order of K are the same.
//
// Both tile plans are computed by the Python wrapper (kernels/conv.py:
// `plan` for float32, `wgmma_plan` for bf16), which the CPU tests reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "conv_sm90.cuh"

namespace {

using conv_sm90::kMaxTaps;
using Taps = conv_sm90::TapTable;

// ---------------------------------------------------------------------------
// float32 route: implicit GEMM on the FP32 FMA units
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // most threads a block
constexpr int TM = 8;             // output pixels a thread
constexpr int TN = 4;             // output channels a thread

// One launch of the f32 kernel, as kernels/conv.py::plan gives it.
struct F32Plan {
  int B, H, W, Cin, Cout;
  int SB, TH, py, px;  // tile SB samples x TH rows x WS; halo rows, columns
  int WS;              // tile columns: W, or a segment of a wide row
  int BM, BN;          // block tile: BM pixels x BN (4..32) channels
  int stages, CL;      // ring stages; blocks of a cluster (the K split)
  int nchunks;         // chunks of BK input channels
  int x16, w16, o16;   // 16-byte copies of x, of the weight; 16-byte stores
  int elu;
};

// Shared memory of one block in floats (kernels/conv.py::f32_smem): the
// ring of stages, each the halo tile [HP][BK + 4] and the chunk's weights
// [T][BK][BN]; the epilogue's partial tile [BM][BN + 4] over the ring; then
// the halo pixels' source offsets [HP] and two tap tables [kMaxTaps] (int).
struct F32Layout {
  int TR, TW, HP, AST, SS, tables, floats;
  __host__ __device__ F32Layout(const F32Plan& p, int T, int BK) {
    TR = p.TH + 2 * p.py;
    TW = p.WS + 2 * p.px;
    HP = p.SB * TR * TW;
    AST = BK + 4;
    SS = HP * AST + T * BK * p.BN;
    const int ring = p.stages * SS, part = p.BM * (p.BN + 4);
    tables = ring > part ? ring : part;
    floats = tables + HP + 2 * kMaxTaps;
  }
  __host__ __device__ int bytes() const { return (floats * 4 + 15) / 16 * 16; }
};

// Block blockIdx.x is rank blockIdx.x % CL of the cluster of output tile
// blockIdx.x / CL (channel tile fastest; with SEG, then the segment of the
// row). A warp holds 8 WM pixels x BN channels: WN = BN / 4 lanes along the
// channels, WM = 32 / WN along the pixels; lane l the pixels qb + WM m
// (m < 8), the channels nb .. nb + 3. SEG (the wide route): a tile is TH
// rows of a segment of WS = W / nseg columns starting at w0; without it a
// tile holds whole rows (WS = W, w0 = 0) and the code is the resident
// route's as it was.
template <int BK, bool SEG>
__global__ void __launch_bounds__(kF32Threads)
    conv2d_taps_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           float* __restrict__ out, const F32Plan p,
                           const Taps taps) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = taps.n;
  const F32Layout L(p, T, BK);
  int* gofs = reinterpret_cast<int*>(smem + L.tables);  // x offset, or -1
  int* toff = gofs + L.HP;      // a tap's shift in the halo, times AST
  int* wrow = toff + kMaxTaps;  // a tap's first weight row
  const int tid = threadIdx.x, NT = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;

  const int CL = p.CL, rank = blockIdx.x % CL, tile = blockIdx.x / CL;
  const int ntn = (p.Cout + p.BN - 1) / p.BN;
  const int n0 = (tile % ntn) * p.BN;
  const int WS = SEG ? p.WS : p.W, nseg = SEG ? p.W / p.WS : 1;
  const int mt = tile / ntn, w0 = SEG ? (mt % nseg) * WS : 0;
  const conv_sm90::Tile tl(SEG ? mt / nseg : mt, p.H, p.TH, p.SB);
  const int tile_px = p.TH * WS, P = p.SB * tile_px;

  for (int hp = tid; hp < L.HP; hp += NT) {
    const int sb = hp / (L.TR * L.TW), rem = hp - sb * L.TR * L.TW;
    const int r = rem / L.TW;
    const int b = tl.b0 + sb, h = tl.h0 - p.py + r;
    const int wc = w0 + rem - r * L.TW - p.px;
    gofs[hp] = b < p.B && h >= 0 && h < p.H && wc >= 0 && wc < p.W
                   ? ((b * p.H + h) * p.W + wc) * p.Cin
                   : -1;
  }
  if (tid == 0) {
#pragma unroll
    for (int t = 0; t < kMaxTaps; ++t) {
      toff[t] = (taps.dy[t] * L.TW + taps.dx[t]) * L.AST;
      wrow[t] = taps.wi[t] * p.Cin;
    }
  }
  __syncthreads();

  // this block's chunks of the K loop: a contiguous range, >= 1
  const int cb = rank * p.nchunks / CL;
  const int mine = (rank + 1) * p.nchunks / CL - cb;
  const int lq = __ffs(p.BN) - 3;  // log2(BN / 4)

  // chunk c into ring slot `slot`: the halo, zero outside the image and
  // past Cin, and the chunk's rows of each live tap's weights, zero past
  // Cin and Cout
  auto load = [&](int slot, int c) {
    float* hs = smem + slot * L.SS;
    float* ws = hs + L.HP * L.AST;
    const int c0 = c * BK;
    if (p.x16) {
      constexpr int QN = BK / 4;
      for (int i = tid; i < L.HP * QN; i += NT) {
        const int hp = i / QN, cc = c0 + 4 * (i % QN), g = gofs[hp];
        const bool ok = g >= 0 && cc < p.Cin;
        sm90::cp_async16(hs + hp * L.AST + cc - c0, ok ? x + g + cc : x,
                         ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < L.HP * BK; i += NT) {
        const int hp = i / BK, cc = c0 + i % BK, g = gofs[hp];
        const bool ok = g >= 0 && cc < p.Cin;
        sm90::cp_async4(hs + hp * L.AST + cc - c0, ok ? x + g + cc : x,
                        ok ? 4 : 0);
      }
    }
    const int ln = p.w16 ? lq : lq + 2;  // log2 of the pieces of a row
    for (int i = tid; i < (T * BK) << ln; i += NT) {
      const int row = i >> ln, k = c0 + row % BK;
      const int col = p.w16 ? 4 * (i & ((1 << ln) - 1)) : i & (p.BN - 1);
      const int n = n0 + col;
      const bool ok = k < p.Cin && n < p.Cout;
      const float* src = ok ? w + (wrow[row / BK] + k) * p.Cout + n : w;
      if (p.w16)
        sm90::cp_async16(ws + row * p.BN + col, src, ok ? 16 : 0);
      else
        sm90::cp_async4(ws + row * p.BN + col, src, ok ? 4 : 0);
    }
  };

  const int WN = p.BN / TN, WM = 32 / WN;
  const int nb = TN * (lane % WN);
  const int qb = warp * TM * WM + lane / WN;
  int hoff[TM];  // the thread's pixels in the halo tile, times AST
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    int q = qb + WM * m;
    if (q >= P) q = P - 1;  // past the tile: reads a real pixel, not stored
    const int sb = q / tile_px, rem = q - sb * tile_px, r = rem / WS;
    hoff[m] = ((sb * L.TR + r + p.py) * L.TW + rem - r * WS + p.px) * L.AST;
  }
  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < mine) load(s, cb + s);
    sm90::cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    sm90::cp_async_wait(p.stages - 2);
    __syncthreads();  // chunk i has landed; chunk i - 1's slot is free
    if (i + p.stages - 1 < mine)
      load((i + p.stages - 1) % p.stages, cb + i + p.stages - 1);
    sm90::cp_async_commit();
    const float* hs = smem + (i % p.stages) * L.SS;
    const float* ws = hs + L.HP * L.AST + nb;
    for (int t = 0; t < T; ++t) {
      const float* at = hs + toff[t];
      const float* bt = ws + t * BK * p.BN;
#pragma unroll
      for (int k4 = 0; k4 < BK / 4; ++k4) {
        float4 a[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m)
          a[m] = *reinterpret_cast<const float4*>(at + hoff[m] + 4 * k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 bv =
              *reinterpret_cast<const float4*>(bt + (4 * k4 + kk) * p.BN);
          const float b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int m = 0; m < TM; ++m) {
            const float v = kk == 0   ? a[m].x
                            : kk == 1 ? a[m].y
                            : kk == 2 ? a[m].z
                                      : a[m].w;
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[m][j] = fmaf(v, b[j], acc[m][j]);
          }
        }
      }
    }
  }

  // the partial tile, over the ring, then summed across the cluster
  sm90::cp_async_wait(0);
  __syncthreads();
  const int PS = p.BN + 4;
  float* part = smem;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    *reinterpret_cast<float4*>(part + (qb + WM * m) * PS + nb) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  if (CL > 1)
    sm90::cluster_sync();
  else
    __syncthreads();
  // this block's 1/CL of the tile's 4-channel pieces: the partials summed
  // in rank order, + bias, ELU, one store
  const int NQ = p.BN / 4, E = p.BM * NQ;
  for (int e = rank * E / CL + tid; e < (rank + 1) * E / CL; e += NT) {
    const int q = e >> lq, n = n0 + 4 * (e & (NQ - 1));
    if (q >= P || n >= p.Cout) continue;
    const int sb = q / tile_px, rem = q - sb * tile_px, r = rem / WS;
    const int b = tl.b0 + sb, h = tl.h0 + r;
    if (b >= p.B || h >= p.H) continue;
    const float* src = part + q * PS + n - n0;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rr = 0; rr < CL; ++rr) {
      const float4 v = CL == 1 ? *reinterpret_cast<const float4*>(src)
                               : sm90::ld_peer4(src, rr);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (bias != nullptr && n + j < p.Cout) v[j] += bias[n + j];
      if (p.elu) v[j] = v[j] > 0.f ? v[j] : expm1f(v[j]);
    }
    float* o =
        out + ((size_t)(b * p.H + h) * p.W + w0 + rem - r * WS) * p.Cout + n;
    if (p.o16) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < p.Cout) o[j] = v[j];
    }
  }
  if (CL > 1) sm90::cluster_sync();  // the peers' reads of this tile are done
}

template <int BK, bool SEG>
cudaError_t launch_f32(const F32Plan& p, const Taps& taps, const float* x,
                       const float* w, const float* bias, float* out,
                       int threads, int smem, cudaStream_t s) {
  auto kernel = conv2d_taps_f32_kernel<BK, SEG>;
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
  const int tiles = p.W / p.WS * ((p.H + p.TH - 1) / p.TH) *
                    ((p.B + p.SB - 1) / p.SB) * ((p.Cout + p.BN - 1) / p.BN);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.CL);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.CL > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, w, bias, out, p,
                                           taps);
  const cudaError_t last = cudaGetLastError();  // cleared either way
  return e != cudaSuccess ? e : last;
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma on a resident halo tile
// ---------------------------------------------------------------------------

using conv_sm90::kMaxWG;
using conv_sm90::Tile;
using bf16 = __nv_bfloat16;

// Shared-memory layout of one block, the same as kernels/conv.py::wgmma_plan
// computes: two halo buffers (a ring over the block's (tile, chunk)
// sequence), the weight slices of every (chunk, tap) for the block's BN
// channels, the epilogue's staging rows, the barriers.
struct TapsLayout {
  int RB;       // halo row bytes: Kc * 2 (Kc = 16 * KS channels per chunk)
  int HB;       // bytes of one halo buffer, a multiple of 1024
  int WS;       // bytes of one weight slice: Kc x BN bf16
  int w_off, st_off, bar_off, bytes;
  __host__ __device__ TapsLayout(int SB, int TR, int TW, int KS, int BN,
                                 int slices, int BM) {
    RB = 32 * KS;
    HB = (SB * TR * TW * RB + 1023) / 1024 * 1024;
    WS = 32 * KS * BN;
    w_off = 2 * HB;
    st_off = w_off + slices * WS;
    bar_off = st_off + BM * (BN + 8) * 2;
    bytes = bar_off + (slices + 4) * 8 + 1024;  // + alignment slack
  }
};

// Warps 0 .. 4*nwg-1 are the consumer warpgroups, warp 4*nwg the producer.
// The block owns output channels n0 = blockIdx.y * BN .. and the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... halo_mode: 2 = TMA, 1 = 4-byte
// cp.async pieces (Cin even), 0 = plain loads, zero-padded; use_wmap:
// weight slices by TMA (else plain loads).
template <int BN, int KS>
__global__ void __launch_bounds__(kMaxWG * 128 + 32)
    conv2d_taps_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap wmap,
                             const bf16* __restrict__ x,
                             const bf16* __restrict__ w,
                             const void* __restrict__ bias, int bias_bf16,
                             bf16* __restrict__ out, int B, int H, int W,
                             int Cin, int Cout, int SB, int TH, int py,
                             int px, int nwg, Taps taps, int elu,
                             int halo_mode, int use_wmap) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ int s_dy[kMaxTaps], s_dx[kMaxTaps], s_wi[kMaxTaps];
  const int TR = TH + 2 * py, TW = W + 2 * px;
  const int Kc = 16 * KS, nchunks = (Cin + Kc - 1) / Kc;
  const int T = taps.n, slices = nchunks * T;
  const TapsLayout L(SB, TR, TW, KS, BN, slices, 64 * nwg);
  uint8_t* halo = base;
  uint8_t* wts = base + L.w_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bar_off);
  uint64_t* hfull = bars;       // [2] a halo buffer has landed
  uint64_t* hempty = bars + 2;  // [2] ... and has been read out
  uint64_t* wfull = bars + 4;   // [slices] a weight slice has landed

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int consumers = 4 * nwg;  // consumer warps
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
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&hfull[i], 1);
      sm90::mbar_init(&hempty[i], consumers);
    }
    for (int i = 0; i < slices; ++i) sm90::mbar_init(&wfull[i], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == consumers) {
    // ---- producer warp ----
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
    // halo u of the block's (tile, chunk) sequence, into buffer u % 2
    auto load_halo = [&](int u, int mt, int c) {
      const int hb = u & 1;
      if (u >= 2) sm90::mbar_wait(&hempty[hb], ((u >> 1) - 1) & 1);
      uint8_t* dst = halo + hb * L.HB;
      const Tile tile(mt, H, TH, SB);
      if (halo_mode == 2) {
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&hfull[hb], SB * TR * TW * L.RB);
          sm90::tma_load_4d(dst, &xmap, &hfull[hb], c * Kc, -px,
                            tile.h0 - py, tile.b0);
        }
        return;
      }
      // channels past Cin stay zero once written: a buffer's first fill
      // writes every piece, later ones only the pieces with channels
      const int pieces = u < 2 ? Kc / 8 : (Cin - c * Kc + 7) / 8;
      const int n = SB * TR * TW * pieces;
      for (int i = lane; i < n; i += 32) {
        const int q = i % pieces;
        int r = i / pieces;
        const int col = r % TW;
        r /= TW;
        const int row = r % TR, sb = r / TR;
        const int b = tile.b0 + sb, h = tile.h0 - py + row, wc = col - px;
        const int cc = c * Kc + 8 * q;
        const bool in = b < B && h >= 0 && h < H && wc >= 0 && wc < W;
        const size_t pix = in ? (((size_t)b * H + h) * W + wc) * Cin : 0;
        uint8_t* d = dst + sm90::swizzle(
            (uint32_t)((sb * TR + row) * TW + col) * L.RB + 16 * q, L.RB);
        if (halo_mode == 1) {  // pairs of channels, zero-filled past Cin
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (u >= 2 && cc + 2 * e >= Cin) break;
            const bool ok = in && cc + 2 * e < Cin;
            sm90::cp_async4(d + 4 * e, ok ? xs + pix + cc + 2 * e : xs,
                            ok ? 4 : 0);
          }
        } else {
          uint32_t v[4] = {0u, 0u, 0u, 0u};
          if (in) {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (cc + e < Cin)
                v[e >> 1] |= (uint32_t)xs[pix + cc + e] << (16 * (e & 1));
          }
          *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      if (halo_mode == 1) sm90::cp_async_arrive(&hfull[hb]);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&hfull[hb]);
    };
    int u = 0;
    if ((int)blockIdx.x < tiles) load_halo(u++, blockIdx.x, 0);
    // every (chunk, tap) weight slice once
    for (int sl = 0; sl < slices; ++sl) {
      const int c = sl / T, row0 = s_wi[sl % T] * Cin + c * Kc;
      conv_sm90::load_weight_slice(
          wts + sl * L.WS, use_wmap ? &wmap : nullptr, w, row0, Kc, BN, n0,
          Cout, [&](int k) { return c * Kc + k < Cin ? row0 + k : -1; },
          &wfull[sl], lane);
    }
    for (int mt = blockIdx.x; mt < tiles; mt += gridDim.x)
      for (int c = (mt == (int)blockIdx.x); c < nchunks; ++c)
        load_halo(u++, mt, c);
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = warp >> 2;
  int p = wg * 64 + (warp & 3) * 16 + (lane & 15);  // this lane's A row
  if (p >= P) p = P - 1;  // rows past the tile repeat a pixel, never stored
  const int row0 = (p / tile_px * TR + p % tile_px / W + py) * TW +
                   p % tile_px % W + px;
  const uint32_t halo_s = sm90::smem_u32(halo);
  const int cb = lane >> 4;  // 16-byte column within a 16-deep k-step
  const int wrb = conv_sm90::weight_row_bytes(BN);
  bf16* st = reinterpret_cast<bf16*>(base + L.st_off) + wg * 64 * (BN + 8);

  float acc[BN / 2];
  uint32_t a0[KS][4], a1[KS][4];
  int u = 0;  // the block's (tile, chunk) sequence
  for (int mt = blockIdx.x; mt < tiles; mt += gridDim.x) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    sm90::fence_acc<BN / 2>(acc);
    // slice i = (chunk c, tap t): gather A rows, issue wgmma; A registers
    // alternate between a0 and a1 so a product runs while the next gathers
    auto slice = [&](uint32_t(&a)[KS][4], int i) {
      const int c = i / T, t = i - c * T, hb = (u + c) & 1;
      if (t == 0) sm90::mbar_wait(&hfull[hb], ((u + c) >> 1) & 1);
      sm90::mbar_wait(&wfull[i], 0);
      const uint32_t hs = halo_s + hb * L.HB;
      const uint32_t row = row0 + s_dy[t] * TW + s_dx[t];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
          sm90::ldsm_x4(
              hs + sm90::swizzle(row * L.RB + (2 * ks + cb) * 16, L.RB),
              a[ks]);
      sm90::wgmma_fence();
      const uint8_t* wb = wts + i * L.WS;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        sm90::Wgmma<BN>::rs(acc, a[ks],
                            sm90::desc_nmajor(wb + ks * 16 * wrb, wrb,
                                              Kc * wrb));
      sm90::wgmma_commit();
      if (t == T - 1) {  // the chunk's halo has been gathered
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&hempty[hb]);
      }
      sm90::wgmma_wait<1>();  // a's other set is free again
    };
    for (int i = 0; i < slices; i += 2) {
      slice(a0, i);
      if (i + 1 < slices) slice(a1, i + 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc<BN / 2>(acc);
    u += nchunks;
    conv_sm90::store_tile<BN>(acc, st, wg, bias, bias_bf16, elu, out,
                              (long long)H * W * Cout, (long long)W * Cout,
                              Cout, n0, Cout, Tile(mt, H, TH, SB), B, H, W,
                              TH, P, Cout % 8 == 0);
  }
}

template <int BN, int KS>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const CUtensorMap& wmap,
                         const void* x, const void* w, const void* bias,
                         int bias_bf16, void* out, int B, int H, int W,
                         int Cin, int Cout, int SB, int TH, int py, int px,
                         int nwg, const Taps& taps, int elu,
                         int halo_mode, int use_wmap, int smem,
                         cudaStream_t s) {
  auto kernel = conv2d_taps_wgmma_kernel<BN, KS>;
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
  const int threads = nwg * 128 + 32;
  const int tiles = (H + TH - 1) / TH * ((B + SB - 1) / SB);
  const int ntiles = (Cout + BN - 1) / BN;
  const dim3 grid(
      conv_sm90::persistent_blocks(reinterpret_cast<const void*>(kernel),
                                   threads, smem, tiles, ntiles),
      ntiles);
  kernel<<<grid, threads, smem, s>>>(
      xmap, wmap, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      bias, bias_bf16, static_cast<bf16*>(out), B, H, W, Cin, Cout, SB, TH,
      py, px, nwg, taps, elu, halo_mode, use_wmap);
  return cudaGetLastError();
}

}  // namespace

// float32 route, with the plan of kernels/conv.py::plan: tiles of TH rows x
// WS columns, WS = W (whole rows), or a segment of a wide row (the SEG
// instance). A 16-byte copy the plan asks for and a pointer cannot take is
// an error, as is a cluster the card refuses; nothing falls back.
extern "C" int sbc_conv2d_taps(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int Cin,
                               int Cout, int ntaps, const int* dy,
                               const int* dx, const int* wi, int SB, int TH,
                               int WS, int py, int px, int BM, int BN, int BK,
                               int stages, int CL, int x16, int w16,
                               int threads, int smem_bytes, int elu,
                               void* stream) {
  Taps taps;
  if (!conv_sm90::make_taps(&taps, ntaps, dy, dx, wi))
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < ntaps; ++t)
    if (dy[t] > py || -dy[t] > py || dx[t] > px || -dx[t] > px)
      return (int)cudaErrorInvalidValue;  // a tap reaches past the halo
  // BN in 4..32, a power of 2: a warp's WN = BN / 4 lanes span it; a warp
  // takes TM * 32 / WN pixels of the BM
  const bool bn = BN == 4 || BN == 8 || BN == 16 || BN == 32;
  if (!bn || (BK != 4 && BK != 8 && BK != 16) ||
      BM % (TM * 32 / (BN / TN)) != 0 || stages < 2 || stages > 4 ||
      (CL != 1 && CL != 2 && CL != 4 && CL != 8) || SB < 1 || TH < 1 ||
      WS < 1 || W % WS != 0 || (WS < W && SB != 1) || SB * TH * WS > BM ||
      threads != BM * BN / TM / TN || threads > kF32Threads)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (Cin + BK - 1) / BK;
  if (nchunks < CL) return (int)cudaErrorInvalidValue;
  const auto a16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if ((x16 && (Cin % 4 != 0 || !a16(x))) ||
      (w16 && (Cout % 4 != 0 || !a16(w))))
    return (int)cudaErrorMisalignedAddress;
  const F32Plan p = {B,  H,  W,  Cin,    Cout, SB,       TH,
                     py, px, WS, BM,     BN,   stages,   CL,
                     nchunks,    x16,    w16,  Cout % 4 == 0 && a16(out),
                     elu};
  const int need = F32Layout(p, ntaps, BK).bytes();
  if (smem_bytes < need) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  const bool seg = WS < W;  // the wide route's row segments
  const auto launch =
      BK == 4   ? (seg ? launch_f32<4, true> : launch_f32<4, false>)
      : BK == 8 ? (seg ? launch_f32<8, true> : launch_f32<8, false>)
                : (seg ? launch_f32<16, true> : launch_f32<16, false>);
  return (int)launch(p, taps, xf, wf, bf, of, threads, smem_bytes, s);
}

// bf16 route: the wgmma kernel, with the plan of kernels/conv.py::wgmma_plan.
// The tensor maps are made here at every launch from the tensors' current
// pointers (nothing cached can go stale).
extern "C" int sbc_conv2d_taps_wgmma(
    const void* x, const void* w, const void* bias, int bias_bf16, void* out,
    int B, int H, int W, int Cin, int Cout, int k, int ntaps, const int* dy,
    const int* dx, const int* wi, int SB, int TH, int py, int px, int BN,
    int KS, int nwg, int smem_bytes, int elu, void* stream) {
  if (nwg < 1 || nwg > kMaxWG ||
      (KS != 1 && KS != 2 && KS != 4) || SB * TH * W > 64 * nwg)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  if (!conv_sm90::make_taps(&taps, ntaps, dy, dx, wi))
    return (int)cudaErrorInvalidValue;
  const int Kc = 16 * KS, TR = TH + 2 * py, TW = W + 2 * px;
  const TapsLayout L(SB, TR, TW, KS, BN, (Cin + Kc - 1) / Kc * ntaps,
                     64 * nwg);
  if (smem_bytes < L.bytes) return (int)cudaErrorInvalidValue;
  // TMA needs 16-byte aligned rows: x with Cin, the weight with Cout a
  // multiple of 8; otherwise the producer warp copies pairs of channels
  // (Cin even) or loads elements. A map TMA should take that the CUDA
  // driver refuses is an error, not a slower form.
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int halo_mode = Cin % 8 == 0 && xa % 16 == 0  ? 2
                        : Cin % 2 == 0 && xa % 4 == 0 ? 1
                                                      : 0;
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof(xmap));
  memset(&wmap, 0, sizeof(wmap));
  const int use_wmap = conv_sm90::weight_takes_tma(w, Cout);
  if (use_wmap &&
      !conv_sm90::make_weight_map(&wmap, w, k * k * Cin, Cout, Kc, BN))
    return (int)cudaErrorNotSupported;
  if (halo_mode == 2) {
    const uint64_t dims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H,
                              (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)Cin * 2, (uint64_t)W * Cin * 2,
                                 (uint64_t)H * W * Cin * 2};
    const uint32_t box[4] = {(uint32_t)Kc, (uint32_t)TW, (uint32_t)TR,
                             (uint32_t)SB};
    if (!sm90::make_map(&xmap, x, 4, dims, strides, box,
                        sm90::swizzle_mode(2 * Kc)))
      return (int)cudaErrorNotSupported;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SBC_TAPS_LAUNCH(N, S)                                               \
  return (int)launch_wgmma<N, S>(xmap, wmap, x, w, bias, bias_bf16, out, B, \
                                 H, W, Cin, Cout, SB, TH, py, px, nwg, taps, \
                                 elu, halo_mode, use_wmap, smem_bytes, s)
#define SBC_TAPS_KS(N)           \
  switch (KS) {                  \
    case 1: SBC_TAPS_LAUNCH(N, 1); \
    case 2: SBC_TAPS_LAUNCH(N, 2); \
    case 4: SBC_TAPS_LAUNCH(N, 4); \
  }                              \
  break
  switch (BN) {
    case 8: SBC_TAPS_KS(8);
    case 16: SBC_TAPS_KS(16);
    case 32: SBC_TAPS_KS(32);
    case 64: SBC_TAPS_KS(64);
    case 128: SBC_TAPS_KS(128);
  }
#undef SBC_TAPS_KS
#undef SBC_TAPS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The last persistent conv launch (either kernel's bf16 route), for the
// card tests: out = {blocks along the tile axis, tiles, channel tiles,
// SMs, the card's blocks per SM for that kernel asked afresh}.
extern "C" int sbc_conv_last_launch(int* out) {
  const conv_sm90::LastLaunch l = conv_sm90::last_launch();
  if (l.kernel == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel,
                                                      l.threads, l.smem);
  const int v[5] = {l.blocks, l.tiles, l.channel_tiles, sms, per_sm};
  memcpy(out, v, sizeof(v));
  return (int)e;
}

extern "C" const char* sbc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
