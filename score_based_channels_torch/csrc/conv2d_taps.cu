// k x k dilated convolution over the live taps, channels-last, stride 1.
//
// Replaces the JAX package's kernels/conv_probe.py::conv_pertap (the
// Pallas per-tap conv: a sum over the live taps of shifted, masked
// (S*B, Cin) x (Cin, Cout) products with f32 accumulation and an optional
// bias + ELU epilogue). It computes the function of every Conv2d of the
// NCSNv2-Deepest forward (models/layers.py Conv2d with dead-tap pruning).
//
// Layouts: x and out are (B, H, W, C) in memory (PyTorch NCHW tensors in
// torch.channels_last); the weight is the module's (Cout, Cin, k, k)
// parameter, laid out in memory as (k*k, Cin, Cout), one (Cin, Cout) matrix
// per tap, in the activation dtype; the kernel reads the live taps only,
// by their index wi = iy*k + ix. The bias is (Cout,) in the activation
// dtype, or NULL.
//
// Bound on an H100: at batch 256 the convs of one forward are ~203 GFLOP
// (>= 0.21 ms on the bf16 tensor cores) and move ~1.2 GB of bf16
// activations (>= 0.35 ms at 3.35 TB/s), so in bf16 the bytes bound them;
// on the FP32 FMA units this kernel uses, the operations take >= 3 ms.
// Design (simple first):
// one block per (group of SB samples, tile of TH output rows); per chunk of
// CK input channels the block stages the input rows with their halo (zero
// padded, so no bounds test in the inner loop) and the chunk of the live
// taps' weights, as f32 (T, CK, cout_pad) with cout_pad = Cout rounded up
// to 4 and zero columns, in shared memory; each thread keeps a 4-pixel x 4-channel f32
// accumulator tile in registers (one float4 weight load and four input
// loads per 16 FMAs).  Epilogue: + bias, ELU, one rounding to the output
// type.  Tensor cores (wgmma) and TMA are later work.
//
// The tile plan (SB, TH, threads, shared bytes) is computed by the Python
// wrapper (kernels/conv.py::plan), which the CPU tests reach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxTaps = 9;
constexpr int RP = 4;        // output pixels per thread
constexpr int RC = 4;        // output channels per thread
constexpr int CK = 8;        // input channels per shared-memory stage
constexpr int CKP = CK + 1;  // padded per-pixel stride: no bank conflicts

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
// four consecutive weights as f32; p is aligned to four elements
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void conv2d_taps_kernel(const T* __restrict__ x,
                                   const T* __restrict__ w,
                                   const T* __restrict__ bias,
                                   T* __restrict__ out, int B, int H, int W,
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
        v = to_f32(x[(((size_t)b * H + h) * W + wc) * Cin + cc]);
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
        const T* src = w + wbase_s[row / CK] + (size_t)cc * Cout + co;
        if (wvec) {
          v = load4(src);
        } else {
          if (co < Cout) v.x = to_f32(src[0]);
          if (co + 1 < Cout) v.y = to_f32(src[1]);
          if (co + 2 < Cout) v.z = to_f32(src[2]);
          if (co + 3 < Cout) v.w = to_f32(src[3]);
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
    T* o = out + (((size_t)b * H + h) * W + wc) * Cout;
#pragma unroll
    for (int k = 0; k < RC; ++k) {
      const int co = cg * RC + k;
      if (co >= Cout) continue;
      float v = acc[j][k];
      if (bias != nullptr) v += to_f32(bias[co]);
      if (elu) v = v > 0.f ? v : expm1f(v);
      store(o + co, v);
    }
  }
}

}  // namespace

extern "C" int sbc_conv2d_taps(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int Cin,
                               int Cout, int ntaps, const int* dy,
                               const int* dx, const int* wi, int SB, int TH,
                               int py, int px, int threads, int smem_bytes,
                               int elu, int bf16, void* stream) {
  if (ntaps < 1 || ntaps > kMaxTaps) return (int)cudaErrorInvalidValue;
  const int cout_pad = (Cout + RC - 1) / RC * RC;
  Taps taps;
  taps.n = ntaps;
  for (int t = 0; t < kMaxTaps; ++t) {
    taps.dy[t] = t < ntaps ? dy[t] : 0;
    taps.dx[t] = t < ntaps ? dx[t] : 0;
    taps.wi[t] = t < ntaps ? wi[t] : 0;
  }
  const dim3 grid((H + TH - 1) / TH, (B + SB - 1) / SB);
  // vector weight loads need whole, aligned groups of four channels
  const size_t esize = bf16 ? 2 : 4;
  const int wvec = Cout % RC == 0 &&
                   reinterpret_cast<size_t>(w) % (RC * esize) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using bf = __nv_bfloat16;
    conv2d_taps_kernel<bf><<<grid, threads, smem_bytes, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(w),
        static_cast<const bf*>(bias), static_cast<bf*>(out), B, H, W, Cin,
        Cout, cout_pad, SB, TH, py, px, taps, elu, wvec);
  } else {
    conv2d_taps_kernel<float><<<grid, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), B, H, W,
        Cin, Cout, cout_pad, SB, TH, py, px, taps, elu, wvec);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sbc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
