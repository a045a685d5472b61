// k x k dilated "same" convolution as one implicit GEMM over the live taps.
//
// Replaces the JAX package's kernels/conv_probe.py::conv_im2col (:135, its
// pallas_call at :169): the Pallas kernel materialises the (S*B, T*Cin)
// patch of the T live taps (shifted, masked, zero where a tap leaves the
// image) in VMEM and does one (S*B, T*Cin) x (T*Cin, Cout) dot with f32
// accumulation, then + bias, optional ELU and one rounding to x's dtype.
//
// Here the GEMM has M = B*H*W rows (pixels), K = T*Cin (live taps only) and
// N = Cout. A block owns a BM x BN tile of the output. It never holds the
// whole patch: it builds its rows of the patch in shared memory one K-chunk
// of (tap, input channel) columns at a time, shifted and masked as the
// Pallas kernel does, beside the matching slice of the weight, and
// accumulates the chunk's product in registers. The weight is read in
// place from the (k, k, Cin, Cout) memory of the tensor (the module's
// (Cout, Cin, k, k) parameter in kernels/conv.py::kernel_layout): each live
// tap's (Cin, Cout) matrix is contiguous there, at wi * Cin * Cout with
// wi = iy * k + ix, so no packed copy of the weight exists that could go
// stale. Dead taps (kernels/conv.py::live_taps) are never visited.
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
//  - bf16 with Cin and Cout multiples of 8: the tensor cores, mma.sync
//    m16n8k16 (bf16 in, f32 accumulation) on 128-pixel x 32- or
//    64-channel block tiles, one warp per 32 x 32. A stage is one tap's 32
//    input channels: the patch rows arrive by cp.async in 16-byte pieces
//    straight from the tap's shifted pixel (zero-filled by the copy itself
//    where the tap leaves the image), the weight slice beside them; three
//    stages keep two copies in flight while the warps multiply the third
//    (ldmatrix, then mma). The patch never exists outside shared memory.
//  - otherwise (float32, or Cin or Cout of 2): the FP32 FMA units, where
//    the operations bound it. Each of the 256 threads keeps a 4-row x
//    4-channel f32 output tile in registers and reads one 16-byte vector of
//    the patch stage and one of the weight stage for every 16 FMAs; Cout <=
//    32 takes a 128 x 32 tile and wider outputs a 64 x 64 tile, so narrow
//    layers waste no columns. Stages are not double-buffered: several
//    blocks per SM hide the loads' latency.
//
// Both grids split Cout as well as the pixels, so the small 8x2 layers
// still launch 64-128 blocks at batch 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 9;
constexpr int NT = 256;  // threads per block
constexpr int BK = 16;   // K columns (tap, input channel) per stage
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output channels per thread

struct Taps {
  int n;
  int dy[kMaxTaps];
  int dx[kMaxTaps];
  int wi[kMaxTaps];  // tap index iy*k + ix into the weight
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// four consecutive elements as f32; p is aligned to four elements
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// up to four consecutive elements, those at or past `valid` read as 0
template <typename T>
__device__ __forceinline__ float4 load4_masked(const T* p, int valid,
                                               int vec) {
  if (valid >= 4 && vec) return load4(p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = to_f32(p[0]);
  if (valid > 1) v.y = to_f32(p[1]);
  if (valid > 2) v.z = to_f32(p[2]);
  if (valid > 3) v.w = to_f32(p[3]);
  return v;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// BN output channels per block; BM = NT*TM*TN/BN output rows (128 for
// BN = 32, 64 for BN = 64)
template <typename T, int BN>
__global__ void __launch_bounds__(NT)
    conv_im2col_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const void* __restrict__ bias, int bias_bf16,
                       T* __restrict__ out, int B, int H, int W, int Cin,
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
    const T* wt = w + (size_t)taps.wi[t] * Cin * Cout;
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
    bv[j] = 0.f;
    if (bias != nullptr && n + j < Cout)
      bv[j] = bias_bf16
                  ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(bias)[n + j])
                  : static_cast<const float*>(bias)[n + j];
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
    const int b = m / HW, rem = m % HW;
    T* o = out + b * os_b + (rem / W) * os_h + (rem % W) * os_w + n;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      v[j] = acc[i][j] + bv[j];
      if (elu) v[j] = v[j] > 0.f ? v[j] : expm1f(v[j]);
    }
    if (vec_o && n + TN <= Cout) {
      store4(o, v);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n + j < Cout) store(o + j, v[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core route
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int MBM = 128;     // output rows per block
constexpr int MBK = 32;      // K columns per stage: one tap, 32 channels
constexpr int kStages = 3;   // cp.async ring
constexpr int AKP = MBK + 8; // patch stage row pitch (5 x 16 bytes: odd)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; only the first src_bytes are read, the rest
// of the 16 are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(const void* p, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(const void* p, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 128 x BN output tile per block, one warp per 32 x 32 of it (BN / 32 x 4
// warps). Each stage holds the patch's 128 rows x 32 columns (one tap, 32
// input channels: four 16-byte pieces a row, each copied from the tap's
// shifted pixel or zero-filled where the tap leaves the image) and the
// weight's 32 x BN slice; cp.async keeps two stages in flight while the
// warps multiply the third with ldmatrix + mma.sync. Cin and Cout are
// multiples of 8; x, w, out and their strides are 16-byte aligned.
template <int BN>
__global__ void __launch_bounds__(BN * 4)
    conv_im2col_mma_kernel(const bf16* __restrict__ x,
                           const bf16* __restrict__ w,
                           const void* __restrict__ bias, int bias_bf16,
                           bf16* __restrict__ out, int B, int H, int W,
                           int Cin, int Cout, long long xs_b, long long xs_h,
                           long long xs_w, long long os_b, long long os_h,
                           long long os_w, Taps taps, int elu) {
  constexpr int NTH = BN * 4;          // threads
  constexpr int BNP = BN + 8;          // weight stage row pitch (odd x 16 B)
  constexpr int A_ELEMS = MBM * AKP;
  constexpr int STAGE = A_ELEMS + MBK * BNP;
  constexpr int RPT = MBM * 4 / NTH;   // patch pieces each thread copies
  extern __shared__ uint4 smem_u4[];
  bf16* smem = reinterpret_cast<bf16*>(smem_u4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HW = H * W, M = B * HW;
  const int m0 = blockIdx.x * MBM, n0 = blockIdx.y * BN;
  const int wm = warp % 4, wn = warp / 4;  // 32 x 32 warp tile

  // the patch pieces this thread copies: row tid / 4 + p * NTH / 4, piece
  // tid % 4 (channels 8 * (tid % 4) .. of the stage's 32)
  const int piece = tid & 3;
  int rh[RPT], rw[RPT];
  long long roff[RPT];
#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    const int m = m0 + tid / 4 + p * (NTH / 4);
    const int mm = m < M ? m : 0;
    const int b = mm / HW, rem = mm % HW;
    rh[p] = m < M ? rem / W : -(1 << 20);  // rows past M: never in range
    rw[p] = rem % W;
    roff[p] = b * xs_b + (rem / W) * xs_h + rw[p] * xs_w;
  }
  // the weight piece: row tid / (BN / 8), eight columns from 8 * (tid % ..)
  const int wr = tid / (BN / 8), wc = (tid % (BN / 8)) * 8;

  const int nc = (Cin + MBK - 1) / MBK;  // stages per tap
  const int total = taps.n * nc;
  auto load = [&](int q) {  // stage q (tap q / nc, channels from c0)
    if (q < total) {
      bf16* a_s = smem + (q % kStages) * STAGE;
      bf16* b_s = a_s + A_ELEMS;
      const int t = q / nc, c0 = (q % nc) * MBK;
      const int dy = taps.dy[t], dx = taps.dx[t];
      const int c = c0 + 8 * piece;
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        const int hh = rh[p] + dy, ww = rw[p] + dx;
        const bool ok = c < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W;
        const bf16* src = ok ? x + roff[p] + dy * xs_h + dx * xs_w + c : x;
        cp_async16(a_s + (tid / 4 + p * (NTH / 4)) * AKP + 8 * piece, src,
                   ok ? 16 : 0);
      }
      if (wr < MBK) {
        const int cc = c0 + wr, n = n0 + wc;
        const bool ok = cc < Cin && n < Cout;
        const bf16* src =
            ok ? w + ((size_t)taps.wi[t] * Cin + cc) * Cout + n : w;
        cp_async16(b_s + wr * BNP + wc, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int q = 0; q < kStages - 1; ++q) load(q);
  for (int q = 0; q < total; ++q) {
    load(q + kStages - 1);  // into the slot read out at q - 1
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* a_s = smem + (q % kStages) * STAGE;
    const bf16* b_s = a_s + A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < MBK; ks += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a_s + (wm * 32 + i * 16 + (lane & 15)) * AKP + ks +
                    8 * (lane >> 4),
                a[i]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned b[4];
        ldsm_x4_trans(b_s + (ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * BNP +
                          wn * 32 + jp * 16 + 8 * (lane >> 4),
                      b);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jp], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the slot is read out before it is refilled
  }

  // epilogue: + bias, ELU, one rounding to bf16, two channels per store
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn * 32 + j * 8 + (lane & 3) * 2;
    if (col >= Cout) continue;
    float bv0 = 0.f, bv1 = 0.f;
    if (bias != nullptr) {
      bv0 = bias_bf16 ? __bfloat162float(static_cast<const bf16*>(bias)[col])
                      : static_cast<const float*>(bias)[col];
      bv1 = bias_bf16
                ? __bfloat162float(static_cast<const bf16*>(bias)[col + 1])
                : static_cast<const float*>(bias)[col + 1];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + i * 16 + (lane >> 2) + 8 * h;
        if (m >= M) continue;
        const int b = m / HW, rem = m % HW;
        float v0 = acc[i][j][2 * h] + bv0, v1 = acc[i][j][2 * h + 1] + bv1;
        if (elu) {
          v0 = v0 > 0.f ? v0 : expm1f(v0);
          v1 = v1 > 0.f ? v1 : expm1f(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + b * os_b + (rem / W) * os_h + (rem % W) * os_w + col) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

template <int BN>
cudaError_t launch_mma(const void* x, const void* w, const void* bias,
                       int bias_bf16, void* out, int B, int H, int W, int Cin,
                       int Cout, long long xs_b, long long xs_h,
                       long long xs_w, long long os_b, long long os_h,
                       long long os_w, const Taps& taps, int elu,
                       cudaStream_t s) {
  constexpr int smem = kStages * (MBM * AKP + MBK * (BN + 8)) * 2;
  static_assert(smem <= 48 * 1024, "stages exceed static shared memory");
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + MBM - 1) / MBM), (Cout + BN - 1) / BN);
  conv_im2col_mma_kernel<BN><<<grid, BN * 4, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias,
      bias_bf16, static_cast<bf16*>(out), B, H, W, Cin, Cout, xs_b, xs_h, xs_w,
      os_b, os_h, os_w, taps, elu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int block_n, const void* x, const void* w,
                   const void* bias, int bias_bf16, void* out, int B, int H,
                   int W, int Cin, int Cout, long long xs_b, long long xs_h,
                   long long xs_w, long long os_b, long long os_h,
                   long long os_w, const Taps& taps, int elu, int vec_x,
                   int vec_w, int vec_o, cudaStream_t s) {
  const long long M = (long long)B * H * W;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  if (block_n == 32) {
    const dim3 grid((unsigned)((M + 127) / 128), (Cout + 31) / 32);
    conv_im2col_kernel<T, 32><<<grid, NT, 0, s>>>(
        xt, wt, bias, bias_bf16, ot, B, H, W, Cin, Cout, xs_b, xs_h, xs_w,
        os_b, os_h, os_w, taps, elu, vec_x, vec_w, vec_o);
  } else if (block_n == 64) {
    const dim3 grid((unsigned)((M + 63) / 64), (Cout + 63) / 64);
    conv_im2col_kernel<T, 64><<<grid, NT, 0, s>>>(
        xt, wt, bias, bias_bf16, ot, B, H, W, Cin, Cout, xs_b, xs_h, xs_w,
        os_b, os_h, os_w, taps, elu, vec_x, vec_w, vec_o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// route 1: the bf16 tensor-core kernel (Cin, Cout multiples of 8, 16-byte
// aligned tensors and strides); route 0: the FMA kernel
extern "C" int sbc_conv_im2col(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int Cin,
                               int Cout, long long xs_b, long long xs_h,
                               long long xs_w, long long os_b, long long os_h,
                               long long os_w, int ntaps, const int* dy,
                               const int* dx, const int* wi, int route,
                               int block_n, int elu, int bf16_in,
                               int bias_bf16, int vec_x, int vec_w, int vec_o,
                               void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps) return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.n = ntaps;
  for (int t = 0; t < kMaxTaps; ++t) {
    taps.dy[t] = t < ntaps ? dy[t] : 0;
    taps.dx[t] = t < ntaps ? dx[t] : 0;
    taps.wi[t] = t < ntaps ? wi[t] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (!bf16_in || Cin % 8 != 0 || Cout % 8 != 0)
      return (int)cudaErrorInvalidValue;
    const cudaError_t e =
        block_n == 32
            ? launch_mma<32>(x, w, bias, bias_bf16, out, B, H, W, Cin, Cout,
                             xs_b, xs_h, xs_w, os_b, os_h, os_w, taps, elu, s)
            : launch_mma<64>(x, w, bias, bias_bf16, out, B, H, W, Cin, Cout,
                             xs_b, xs_h, xs_w, os_b, os_h, os_w, taps, elu, s);
    return (int)e;
  }
  const cudaError_t e =
      bf16_in ? launch<__nv_bfloat16>(block_n, x, w, bias, bias_bf16, out, B, H,
                                   W, Cin, Cout, xs_b, xs_h, xs_w, os_b, os_h,
                                   os_w, taps, elu, vec_x, vec_w, vec_o, s)
           : launch<float>(block_n, x, w, bias, bias_bf16, out, B, H, W, Cin,
                           Cout, xs_b, xs_h, xs_w, os_b, os_h, os_w, taps,
                           elu, vec_x, vec_w, vec_o, s);
  return (int)e;
}
