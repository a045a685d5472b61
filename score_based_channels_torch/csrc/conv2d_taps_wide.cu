// The wide bf16 route of conv2d_taps: k x k dilated convolution over the
// live taps, channels-last, stride 1, for layers the resident-weight
// kernel of conv2d_taps.cu cannot hold: up to 512 input and output
// channels and images up to 256 pixels wide (NCSNv2-Deepest at its
// published FFHQ widths: ngf 128, 256x256x3 images, 128-512 channels).
//
// It computes what conv2d_taps_wgmma_kernel computes (the JAX package's
// kernels/conv_probe.py::conv_pertap: a sum over the live taps of shifted
// (pixels, Cin) x (Cin, Cout) products, f32 accumulation, + bias, ELU, one
// rounding to bf16), with the same layouts: x and out (B, H, W, C) in
// memory, the weight (k*k, Cin, Cout), one (Cin, Cout) matrix per tap.
//
// Bound on an H100: operations. A 3x3 conv of 128 or more channels does
// 2 * 9 * Cin operations for each output byte pair it writes, 576 or more
// per byte at Cin = Cout = 128, above the card's 295 (989 TFLOP/s over
// 3.35 TB/s). What holds such a kernel back is feeding the tensor cores:
//  - the old route keeps every (chunk, tap) weight slice of its output
//    channels resident in shared memory; at 512 x 512 x 9 taps that is
//    4.7 MB. Here the weight slices stream through a ring of 2-8 stages
//    (TMA, one Kc x BN slice a stage), so any channel count fits;
//  - a block's tile is 64 NWG output pixels (NWG = 2 or 4 consumer
//    warpgroups of 64 rows): SB samples x TH whole rows where a row holds
//    at most 128 pixels, else TH rows of a segment of WS = W / segments
//    columns; four warpgroups share each weight stage twice as widely.
//    Each
//    (tile, chunk of up to 64 input channels) comes in as one TMA box
//    with its halo, (chunk, WS + 2px, TH + 2py, SB) from (c0, w0 - px,
//    h0 - py, b0), zero-filled outside the tensor (the conv's padding),
//    into a ring of two buffers; every live tap reads it at its shift,
//    so the activation is read once a chunk, not once a tap;
//  - per (chunk, tap) slice each lane gives ldmatrix its pixel's shifted
//    row of the halo, and the warpgroup issues wgmma with A from those
//    registers and B from the weight stage; two sets of A registers let
//    one slice's product run while the next slice's rows are gathered,
//    and a stage is handed back to the producer once the product that
//    read it has completed (wgmma.wait_group);
//  - output channels are tiled over the grid's y (BN <= 128, a wgmma N);
//    a block is persistent over its channel tile's output tiles, so the
//    next tile's first halo and slices land while it stores this one.
// x with Cin not a multiple of 8 (the 3-channel begin conv) takes the halo
// by 4-byte cp.async (Cin even) or plain loads, and a weight with Cout not
// a multiple of 8 (the 3-channel end conv, an N = 8 tile) its slices by
// plain loads, zero-padded, as in conv2d_taps.cu. Epilogue: + bias, ELU,
// one rounding to bf16, stored from the registers as channel pairs (the
// output is a sliver of these layers' time; the shared memory a staging
// buffer would take holds the halo of a 256-pixel tile instead).
//
// The tile plan is computed by kernels/conv.py::wide_plan, which the CPU
// tests reach; kernels/conv.py sends a bf16 launch here when a channel
// count passes 128 or the image is wider than 128 pixels, and every other
// shape to conv2d_taps.cu, unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "conv_sm90.cuh"

namespace {

using conv_sm90::kMaxTaps;
using conv_sm90::Tile;
using Taps = conv_sm90::TapTable;
using bf16 = __nv_bfloat16;

constexpr int kMaxStages = 8;  // weight stages of the ring

// Shared-memory layout of one block (kernels/conv.py::wide_smem): two halo
// buffers of 1 KB multiples, the ring of weight stages (Kc x BN bf16 each),
// the barriers, 1 KB of alignment.
struct WideLayout {
  int RB;  // halo row bytes: Kc * 2
  int HB;  // bytes of one halo buffer
  int WB;  // bytes of one weight stage
  int w_off, bar_off, bytes;
  __host__ __device__ WideLayout(int SB, int TR, int TW, int KS, int BN,
                                 int stages) {
    RB = 32 * KS;
    HB = (SB * TR * TW * RB + 1023) / 1024 * 1024;
    WB = 32 * KS * BN;
    w_off = 2 * HB;
    bar_off = w_off + stages * WB;
    bytes = bar_off + (4 + 2 * stages) * 8 + 1024;
  }
};

// The epilogue of one consumer warp: + bias (f32 or bf16), ELU, one
// rounding to bf16, channel pairs stored from the accumulator (wgmma's
// layout: for n-block j, acc[4j], acc[4j + 1] at row 16 (warp % 4) +
// lane / 4, columns 8j + 2 (lane % 4) + {0, 1}; acc[4j + 2], acc[4j + 3]
// eight rows below). o[h] points at this lane's pixel of row h (0, 1) at
// channel n0, or is null where the row lies outside the tensor.
template <int BN>
__device__ __forceinline__ void store_pairs(const float* acc, bf16* o0,
                                            bf16* o1, const void* bias,
                                            int bias_bf16, int elu, int n0,
                                            int Cout, int lane) {
  bf16* o[2] = {o0, o1};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3), n = n0 + col;
    if (n >= Cout) break;
    float bv0 = 0.f, bv1 = 0.f;
    if (bias != nullptr) {
      if (bias_bf16) {
        const bf16* bb = static_cast<const bf16*>(bias);
        bv0 = __bfloat162float(bb[n]);
        if (n + 1 < Cout) bv1 = __bfloat162float(bb[n + 1]);
      } else {
        const float* bb = static_cast<const float*>(bias);
        bv0 = bb[n];
        if (n + 1 < Cout) bv1 = bb[n + 1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (o[h] == nullptr) continue;
      float v0 = acc[4 * j + 2 * h] + bv0, v1 = acc[4 * j + 2 * h + 1] + bv1;
      if (elu) {
        v0 = v0 > 0.f ? v0 : expm1f(v0);
        v1 = v1 > 0.f ? v1 : expm1f(v1);
      }
      if (n + 1 < Cout && (Cout & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o[h] + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        o[h][col] = __float2bfloat16(v0);
        if (n + 1 < Cout) o[h][col + 1] = __float2bfloat16(v1);
      }
    }
  }
}

// Output tile mt: row segment fastest, then row tile, then sample group.
struct WideTile {
  Tile t;
  int w0;
  __device__ __forceinline__ WideTile(int mt, int H, int TH, int SB,
                                      int nseg, int WS)
      : t(mt / nseg, H, TH, SB), w0((mt % nseg) * WS) {}
};

// Warps 0 .. 4 NWG - 1 are the consumer warpgroups, warp 4 NWG the
// producer. The block
// owns output channels n0 = blockIdx.y * BN .. and the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... halo_mode: 2 = TMA, 1 = 4-byte cp.async
// pieces (Cin even), 0 = plain loads, zero-padded; use_wmap: weight slices
// by TMA (else plain loads).
template <int BN, int KS, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32)
    conv2d_taps_wide_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap wmap,
                            const bf16* __restrict__ x,
                            const bf16* __restrict__ w,
                            const void* __restrict__ bias, int bias_bf16,
                            bf16* __restrict__ out, int B, int H, int W,
                            int Cin, int Cout, int SB, int TH, int WS,
                            int py, int px, int stages, Taps taps, int elu,
                            int halo_mode, int use_wmap) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ int s_dy[kMaxTaps], s_dx[kMaxTaps], s_wi[kMaxTaps];
  const int TR = TH + 2 * py, TW = WS + 2 * px;
  const int Kc = 16 * KS, nchunks = (Cin + Kc - 1) / Kc;
  const int T = taps.n, slices = nchunks * T;
  const WideLayout L(SB, TR, TW, KS, BN, stages);
  uint8_t* halo = base;
  uint8_t* wts = base + L.w_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bar_off);
  uint64_t* hfull = bars;                 // [2] a halo buffer has landed
  uint64_t* hempty = bars + 2;            // [2] ... and has been read out
  uint64_t* wfull = bars + 4;             // [stages] a weight stage landed
  uint64_t* wempty = bars + 4 + stages;   // [stages] ... and was multiplied

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int consumers = 4 * NWG;  // consumer warps
  const int n0 = blockIdx.y * BN;
  const int nseg = W / WS;
  const int tiles = nseg * ((H + TH - 1) / TH) * ((B + SB - 1) / SB);
  const int tile_px = TH * WS, P = SB * tile_px;

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
    for (int i = 0; i < stages; ++i) {
      sm90::mbar_init(&wfull[i], 1);
      sm90::mbar_init(&wempty[i], consumers);
    }
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
      const WideTile tile(mt, H, TH, SB, nseg, WS);
      if (halo_mode == 2) {
        if (lane == 0) {
          sm90::mbar_arrive_expect_tx(&hfull[hb], SB * TR * TW * L.RB);
          sm90::tma_load_4d(dst, &xmap, &hfull[hb], c * Kc, tile.w0 - px,
                            tile.t.h0 - py, tile.t.b0);
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
        const int b = tile.t.b0 + sb, h = tile.t.h0 - py + row;
        const int wc = tile.w0 + col - px;
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
    // weight slice g of the block's sequence, (chunk c, tap t), into stage
    // g % stages once the products that read its last fill are done
    auto load_slice = [&](int g, int c, int t) {
      const int s = g % stages;
      if (g >= stages) sm90::mbar_wait(&wempty[s], ((g / stages) - 1) & 1);
      const int row0 = s_wi[t] * Cin + c * Kc;
      conv_sm90::load_weight_slice(
          wts + s * L.WB, use_wmap ? &wmap : nullptr, w, row0, Kc, BN, n0,
          Cout, [&](int k) { return c * Kc + k < Cin ? row0 + k : -1; },
          &wfull[s], lane);
    };
    int u = 0, g = 0;
    for (int mt = blockIdx.x; mt < tiles; mt += gridDim.x)
      for (int c = 0; c < nchunks; ++c) {
        load_halo(u++, mt, c);
        for (int t = 0; t < T; ++t) load_slice(g++, c, t);
      }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = warp >> 2;
  int p = wg * 64 + (warp & 3) * 16 + (lane & 15);  // this lane's A row
  if (p >= P) p = P - 1;  // rows past the tile repeat a pixel, never stored
  const int row0 = (p / tile_px * TR + p % tile_px / WS + py) * TW +
                   p % tile_px % WS + px;
  const uint32_t halo_s = sm90::smem_u32(halo);
  const int cb = lane >> 4;  // 16-byte column within a 16-deep k-step
  const int wrb = conv_sm90::weight_row_bytes(BN);
  // the two output rows of this lane: pixels er + {0, 8} of the tile
  const int er = wg * 64 + (warp & 3) * 16 + (lane >> 2);

  float acc[BN / 2];
  uint32_t a0[KS][4], a1[KS][4];
  int u = 0, g = 0;  // the block's (tile, chunk) and slice sequences
  for (int mt = blockIdx.x; mt < tiles; mt += gridDim.x) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    sm90::fence_acc<BN / 2>(acc);
    // slice i = (chunk c, tap t) of this tile, g + i of the block's
    // sequence: gather A rows, issue wgmma; A registers alternate between
    // a0 and a1 so a product runs while the next gathers
    auto slice = [&](uint32_t(&a)[KS][4], int i) {
      const int c = i / T, t = i - c * T, hb = (u + c) & 1;
      const int gi = g + i, s = gi % stages;
      if (t == 0) sm90::mbar_wait(&hfull[hb], ((u + c) >> 1) & 1);
      sm90::mbar_wait(&wfull[s], (gi / stages) & 1);
      const uint32_t hs = halo_s + hb * L.HB;
      const uint32_t row = row0 + s_dy[t] * TW + s_dx[t];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        sm90::ldsm_x4(
            hs + sm90::swizzle(row * L.RB + (2 * ks + cb) * 16, L.RB),
            a[ks]);
      // the descriptors are made before the fence and pinned there: an
      // instruction that defines a wgmma's input between the fence and
      // the commit makes ptxas serialize the products
      const uint8_t* wb = wts + s * L.WB;
      uint64_t db[KS];
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        db[ks] = sm90::desc_nmajor(wb + ks * 16 * wrb, wrb, Kc * wrb);
        asm volatile("" : "+l"(db[ks]));
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) sm90::Wgmma<BN>::rs(acc, a[ks], db[ks]);
      sm90::wgmma_commit();
      if (t == T - 1) {  // the chunk's halo has been gathered
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&hempty[hb]);
      }
      sm90::wgmma_wait<1>();  // slice i - 1's product is done
      if (i > 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&wempty[(gi - 1) % stages]);
      }
    };
    for (int i = 0; i < slices; i += 2) {
      slice(a0, i);
      if (i + 1 < slices) slice(a1, i + 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_acc<BN / 2>(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&wempty[(g + slices - 1) % stages]);
    u += nchunks;
    g += slices;
    const WideTile tile(mt, H, TH, SB, nseg, WS);
    bf16* o[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = er + 8 * h, rem = pp % tile_px;
      const int b = tile.t.b0 + pp / tile_px, y = tile.t.h0 + rem / WS;
      o[h] = pp < P && b < B && y < H
                 ? out + (((size_t)b * H + y) * W + tile.w0 + rem % WS) *
                             Cout + n0
                 : nullptr;
    }
    store_pairs<BN>(acc, o[0], o[1], bias, bias_bf16, elu, n0, Cout, lane);
  }
}

template <int BN, int KS, int NWG>
cudaError_t launch_wide(const CUtensorMap& xmap, const CUtensorMap& wmap,
                        const void* x, const void* w, const void* bias,
                        int bias_bf16, void* out, int B, int H, int W,
                        int Cin, int Cout, int SB, int TH, int WS, int py,
                        int px, int stages, const Taps& taps, int elu,
                        int halo_mode, int use_wmap, int smem,
                        cudaStream_t s) {
  auto kernel = conv2d_taps_wide_kernel<BN, KS, NWG>;
  constexpr int threads = NWG * 128 + 32;
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
  const int tiles =
      W / WS * ((H + TH - 1) / TH) * ((B + SB - 1) / SB);
  const int ntiles = (Cout + BN - 1) / BN;
  const dim3 grid(
      conv_sm90::persistent_blocks(reinterpret_cast<const void*>(kernel),
                                   threads, smem, tiles, ntiles),
      ntiles);
  kernel<<<grid, threads, smem, s>>>(
      xmap, wmap, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      bias, bias_bf16, static_cast<bf16*>(out), B, H, W, Cin, Cout, SB, TH,
      WS, py, px, stages, taps, elu, halo_mode, use_wmap);
  return cudaGetLastError();
}

}  // namespace

// The wide bf16 route, with the plan of kernels/conv.py::wide_plan. The
// tensor maps are made here at every launch from the tensors' current
// pointers (nothing cached can go stale). A map TMA should take that the
// CUDA driver refuses is an error, not a slower form.
extern "C" int sbc_conv2d_taps_wide(
    const void* x, const void* w, const void* bias, int bias_bf16, void* out,
    int B, int H, int W, int Cin, int Cout, int k, int ntaps, const int* dy,
    const int* dx, const int* wi, int SB, int TH, int WS, int py, int px,
    int BN, int KS, int nwg, int stages, int smem_bytes, int elu,
    void* stream) {
  if ((KS != 1 && KS != 2 && KS != 4) || (nwg != 2 && nwg != 4) ||
      stages < 2 || stages > kMaxStages || WS < 1 || W % WS != 0 ||
      SB < 1 || TH < 1 || SB * TH * WS > 64 * nwg || (WS < W && SB != 1))
    return (int)cudaErrorInvalidValue;
  Taps taps;
  if (!conv_sm90::make_taps(&taps, ntaps, dy, dx, wi))
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < ntaps; ++t)
    if (dy[t] > py || -dy[t] > py || dx[t] > px || -dx[t] > px)
      return (int)cudaErrorInvalidValue;  // a tap reaches past the halo
  const int Kc = 16 * KS, TR = TH + 2 * py, TW = WS + 2 * px;
  if (TR > 256 || TW > 256 || SB > 256) return (int)cudaErrorInvalidValue;
  const WideLayout L(SB, TR, TW, KS, BN, stages);
  if (smem_bytes < L.bytes) return (int)cudaErrorInvalidValue;
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
#define SBC_WIDE_LAUNCH(N, S, G)                                          \
  return (int)launch_wide<N, S, G>(xmap, wmap, x, w, bias, bias_bf16, out, \
                                   B, H, W, Cin, Cout, SB, TH, WS, py, px,   \
                                   stages, taps, elu, halo_mode, use_wmap,   \
                                   smem_bytes, s)
#define SBC_WIDE_G(N, S)                           \
  if (nwg == 4) SBC_WIDE_LAUNCH(N, S, 4);          \
  SBC_WIDE_LAUNCH(N, S, 2)
#define SBC_WIDE_KS(N)           \
  switch (KS) {                  \
    case 1: SBC_WIDE_G(N, 1);    \
    case 2: SBC_WIDE_G(N, 2);    \
    case 4: SBC_WIDE_G(N, 4);    \
  }                              \
  break
  switch (BN) {
    case 8: SBC_WIDE_KS(8);
    case 16: SBC_WIDE_KS(16);
    case 32: SBC_WIDE_KS(32);
    case 64: SBC_WIDE_KS(64);
    case 128: SBC_WIDE_KS(128);
  }
#undef SBC_WIDE_KS
#undef SBC_WIDE_G
#undef SBC_WIDE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
