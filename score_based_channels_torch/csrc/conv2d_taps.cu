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
//  - float32: the FP32 FMA units (the JAX package's f32 bar of 1e-5 of
//    max|ref| rules out TF32), unchanged from the first port. One block per (group of SB samples, tile of
//    TH output rows); per chunk of CK input channels the block stages the
//    input rows with their halo (zero padded) and the chunk of the live
//    taps' weights, as f32 (T, CK, cout_pad) with cout_pad = Cout rounded
//    up to 4 and zero columns, in shared memory; each thread keeps a
//    4-pixel x 4-channel f32 accumulator tile in registers.
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
constexpr int RP = 4;        // output pixels per thread
constexpr int RC = 4;        // output channels per thread
constexpr int CK = 8;        // input channels per shared-memory stage
constexpr int CKP = CK + 1;  // padded per-pixel stride: no bank conflicts

using Taps = conv_sm90::TapTable;

// four consecutive weights; p is aligned to four elements
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__global__ void conv2d_taps_kernel(const float* __restrict__ x,
                                   const float* __restrict__ w,
                                   const float* __restrict__ bias,
                                   float* __restrict__ out, int B, int H, int W,
                                   int Cin, int Cout, int cout_pad, int SB,
                                   int TH, int py, int px, Taps taps, int elu,
                                   int wvec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int TR = TH + 2 * py;  // staged rows per sample
  const int TW = W + 2 * px;   // staged columns
  const int in_size = SB * TR * TW * CKP;
  float* in_s = smem;                            // [SB][TR][TW][CKP]
  float* w_s = smem + ((in_size + 3) & ~3);      // [T][CK][cout_pad]

  const int b0 = blockIdx.y * SB;
  const int h0 = blockIdx.x * TH;
  const int ncg = cout_pad / RC;
  const int tile_px = TH * W;
  const int npix = SB * tile_px;
  const int tid = threadIdx.x;
  const int cg = tid % ncg;
  const int p_first = (tid / ncg) * RP;
  const bool active = p_first < npix;

  int pix_off[RP];
#pragma unroll
  for (int j = 0; j < RP; ++j) {
    int p = p_first + j;
    if (p >= npix) p = 0;  // padding lane: reads a valid pixel, never stored
    const int sb = p / tile_px;
    const int rem = p % tile_px;
    pix_off[j] = ((sb * TR + rem / W + py) * TW + rem % W + px) * CKP;
  }

  // offset of each live tap's (Cin, Cout) matrix in the weight
  __shared__ size_t wbase_s[kMaxTaps];
  if (tid < taps.n) wbase_s[tid] = (size_t)taps.wi[tid] * Cin * Cout;

  float acc[RP][RC];
#pragma unroll
  for (int j = 0; j < RP; ++j)
#pragma unroll
    for (int k = 0; k < RC; ++k) acc[j][k] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CK) {
    __syncthreads();  // the previous stage has been consumed
    for (int i = tid; i < SB * TR * TW * CK; i += blockDim.x) {
      const int ci = i % CK;
      int rest = i / CK;
      const int col = rest % TW;
      rest /= TW;
      const int row = rest % TR;
      const int sb = rest / TR;
      const int b = b0 + sb, h = h0 + row - py, wc = col - px, cc = c0 + ci;
      float v = 0.f;
      if (b < B && h >= 0 && h < H && wc >= 0 && wc < W && cc < Cin)
        v = x[(((size_t)b * H + h) * W + wc) * Cin + cc];
      in_s[((sb * TR + row) * TW + col) * CKP + ci] = v;
    }
    // four output channels per item, one flat loop unrolled so that
    // several loads are in flight; the tap's offset comes from shared
    // memory, not from a divergent index into the kernel's parameters
    const int cq = cout_pad / RC;
#pragma unroll 4
    for (int i = tid; i < taps.n * CK * cq; i += blockDim.x) {
      const int co = (i % cq) * RC;
      const int row = i / cq;  // t * CK + ci
      const int cc = c0 + row % CK;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cc < Cin) {
        const float* src = w + wbase_s[row / CK] + (size_t)cc * Cout + co;
        if (wvec) {
          v = load4(src);
        } else {
          if (co < Cout) v.x = src[0];
          if (co + 1 < Cout) v.y = src[1];
          if (co + 2 < Cout) v.z = src[2];
          if (co + 3 < Cout) v.w = src[3];
        }
      }
      *reinterpret_cast<float4*>(w_s + row * cout_pad + co) = v;
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < taps.n; ++t) {
        const int toff = (taps.dy[t] * TW + taps.dx[t]) * CKP;
        const float* wt = w_s + t * CK * cout_pad + cg * RC;
#pragma unroll
        for (int ci = 0; ci < CK; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(wt + ci * cout_pad);
#pragma unroll
          for (int j = 0; j < RP; ++j) {
            const float v = in_s[pix_off[j] + toff + ci];
            acc[j][0] = fmaf(v, wv.x, acc[j][0]);
            acc[j][1] = fmaf(v, wv.y, acc[j][1]);
            acc[j][2] = fmaf(v, wv.z, acc[j][2]);
            acc[j][3] = fmaf(v, wv.w, acc[j][3]);
          }
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < RP; ++j) {
    const int p = p_first + j;
    if (p >= npix) continue;
    const int sb = p / tile_px;
    const int rem = p % tile_px;
    const int b = b0 + sb, h = h0 + rem / W, wc = rem % W;
    if (b >= B || h >= H) continue;
    float* o = out + (((size_t)b * H + h) * W + wc) * Cout;
#pragma unroll
    for (int k = 0; k < RC; ++k) {
      const int co = cg * RC + k;
      if (co >= Cout) continue;
      float v = acc[j][k];
      if (bias != nullptr) v += bias[co];
      if (elu) v = v > 0.f ? v : expm1f(v);
      o[co] = v;
    }
  }
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

// float32 route: the FMA kernel
extern "C" int sbc_conv2d_taps(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int Cin,
                               int Cout, int ntaps, const int* dy,
                               const int* dx, const int* wi, int SB, int TH,
                               int py, int px, int threads, int smem_bytes,
                               int elu, void* stream) {
  const int cout_pad = (Cout + RC - 1) / RC * RC;
  Taps taps;
  if (!conv_sm90::make_taps(&taps, ntaps, dy, dx, wi))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((H + TH - 1) / TH, (B + SB - 1) / SB);
  // vector weight loads need whole, aligned groups of four channels
  const int wvec = Cout % RC == 0 &&
                   reinterpret_cast<size_t>(w) % (RC * sizeof(float)) == 0;
  conv2d_taps_kernel<<<grid, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, Cin,
      Cout, cout_pad, SB, TH, py, px, taps, elu, wvec);
  return (int)cudaGetLastError();
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
