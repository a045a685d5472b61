// The two-pass route of instance_norm_plus: InstanceNorm++ with an optional
// fused ELU, channels-last, for samples that instance_norm_plus.cu cannot
// hold: more than 128 channels, or more bytes than 8 blocks' shared memory
// (NCSNv2-Deepest at its published FFHQ widths: a 256x256x128 bf16 sample
// is 16.8 MB, and 128x128 to 32x32 samples carry 256-512 channels).
//
// It computes what instance_norm_plus_kernel computes (the JAX package's
// kernels/instance_norm.py::instance_norm_plus_pallas: per sample, the
// per-channel spatial mean and biased variance, the mean and UNBIASED
// variance of the channel means, gamma*((x - mu)/sqrt(var + 1e-5) +
// alpha*m_hat) + beta, optional ELU), with the same layouts: x and out
// (B, H*W, C) in memory, f32 or bf16, alpha/gamma/beta (C,) in that dtype;
// statistics in f32.
//
// Bound on an H100: bytes, one read and one write of the activation. A
// sample is spread over many blocks, so the statistics need a reduction
// across blocks; it is made deterministic (fixed order, no atomics: two
// launches give equal bits) in three kernels:
//  1. stats: a block a tile of TP pixels x all C channels of one sample;
//     each thread loads its 8 pixels' 8-channel vectors into registers by
//     16-byte loads, and the block forms the tile's per-channel mean and
//     sum of squared deviations from it (two passes over the registers,
//     so no E[x^2] - mu^2 cancellation), summed over the block's pixel
//     rows in row order; written as (mean, M2) per (sample, tile,
//     channel);
//  2. finalize: a block a sample; threads combine a channel's tiles'
//     (count, mean, M2) in tile order in 2-128 contiguous parts (Chan et
//     al.'s pairwise update), then the parts in order, then
//     the channel means' mean and unbiased variance, and writes each
//     channel's scale gamma / sqrt(var + 1e-5) and shift gamma * alpha *
//     m_hat + beta;
//  3. apply: out = (x - mu) * scale + shift (+ ELU), 16-byte vectors,
//     the activation read once more (from L2 where it still lies) and the
//     output written once.
// The tiles' partials and the per-channel statistics lie in a workspace the
// wrapper allocates (kernels/instance_norm.py::two_pass_plan sizes it).
// ELU as in instance_norm_plus.cu: expm1f in f32, __expf(y) - 1 in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 512;
constexpr int kStatsThreads = 256;  // most threads of a stats block
constexpr int kNP = 8;              // pixel vectors a stats thread holds
constexpr int kApplyThreads = 256;
constexpr int kApplyVecs = 4;       // vectors an apply thread takes
constexpr int kFinalThreads = 1024; // most threads of a finalize block

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float apply_elu(float y) {
  if (y > 0.f) return y;
  return sizeof(T) == 4 ? expm1f(y) : __expf(y) - 1.f;
}

// The sum over the block's pixel rows of each thread's 8 values, in row
// order, by the threads of row 0 (red: rows x C floats); returns the sums
// of this thread's channels in row 0's threads (others: unspecified).
__device__ __forceinline__ void row_sums(float* v, float* red, int row,
                                         int ci, int C, int rows) {
#pragma unroll
  for (int e = 0; e < 8; ++e) red[row * C + ci + e] = v[e];
  __syncthreads();
  if (row == 0) {
    for (int r = 1; r < rows; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += red[r * C + ci + e];
  }
  __syncthreads();
}

// grid (tiles, B); block: rows x cv threads (cv = C / 8), thread (row, cg)
// holding channels 8 cg .. 8 cg + 7 of pixels tile * TP + row + k * rows,
// k < kNP. part: (B, tiles, 2, C) f32: the tile's mean, then its M2.
template <typename T>
__global__ void __launch_bounds__(kStatsThreads)
    instance_norm_plus_stats_kernel(const T* __restrict__ x,
                                    float* __restrict__ part, int HW, int C,
                                    int rows, int tiles) {
  extern __shared__ float red[];  // rows x C, then the tile's means
  float* tmean = red + rows * C;
  const int cv = C / 8, tid = threadIdx.x;
  const int row = tid / cv, cg = tid % cv, ci = 8 * cg;
  const int b = blockIdx.y, tile = blockIdx.x, TP = rows * kNP;
  const int p0 = tile * TP, n = min(TP, HW - p0);
  const T* xs = x + ((size_t)b * HW + p0) * C + ci;
  float v[kNP][8], s[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = 0.f;
#pragma unroll
  for (int k = 0; k < kNP; ++k) {
    const int p = row + k * rows;
    if (p < n) {
      load8(xs + (size_t)p * C, v[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] += v[k][e];
    }
  }
  row_sums(s, red, row, ci, C, rows);
  if (row == 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) tmean[ci + e] = s[e] / n;
  }
  __syncthreads();
  float m[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = tmean[ci + e];
    s[e] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < kNP; ++k) {
    if (row + k * rows < n) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[k][e] - m[e];
        s[e] += d * d;
      }
    }
  }
  row_sums(s, red, row, ci, C, rows);
  if (row == 0) {
    float* o = part + ((size_t)b * tiles + tile) * 2 * C + ci;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      o[e] = m[e];
      o[C + e] = s[e];
    }
  }
}

// Chan et al.'s update: (n, mean, m2) += a part of nb values, mean mb,
// sum of squared deviations qb
__device__ __forceinline__ void chan(float& n, float& mean, float& m2,
                                     float nb, float mb, float qb) {
  if (nb == 0.f) return;  // an empty part (fewer tiles than parts)
  const float tot = n + nb, d = mb - mean;
  mean += d * (nb / tot);
  m2 += qb + d * d * (n * nb / tot);
  n = tot;
}

// grid B; block: C x R threads (R = kFinalThreads / C parts of the tiles)
// rounded up to whole warps. Thread (r, c) combines tiles [r T / R, (r + 1) T / R) of
// channel c in order, then thread (0, c) the R parts in order. stat:
// (B, 3, C) f32: each channel's mean, scale and shift.
template <typename T>
__global__ void __launch_bounds__(kFinalThreads)
    instance_norm_plus_finalize_kernel(const float* __restrict__ part,
                                       const T* __restrict__ alpha,
                                       const T* __restrict__ gamma,
                                       const T* __restrict__ beta,
                                       float* __restrict__ stat, int HW,
                                       int C, int TP, int tiles) {
  __shared__ float red[kFinalThreads / 32];
  __shared__ float pn[kFinalThreads], pm[kFinalThreads], pq[kFinalThreads];
  __shared__ float mm, rv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = blockDim.x / C, c = tid % C, r = tid / C;
  const int b = blockIdx.x;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (r < R) {
    const float* p = part + (size_t)b * tiles * 2 * C + c;
    const int t1 = (r + 1) * tiles / R;
#pragma unroll 4
    for (int t = r * tiles / R; t < t1; ++t)
      chan(n, mean, m2, (float)min(TP, HW - t * TP), p[(size_t)t * 2 * C],
           p[(size_t)t * 2 * C + C]);
    pn[tid] = n, pm[tid] = mean, pq[tid] = m2;
  }
  __syncthreads();
  if (r == 0) {
    for (int k = 1; k < R; ++k)
      chan(n, mean, m2, pn[k * C + c], pm[k * C + c], pq[k * C + c]);
  }
  const bool own = r == 0;  // this thread holds channel c's statistics
  // the channel means' mean, then their unbiased variance (fixed order)
  auto block_sum = [&](float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int k = 0; k < (int)((blockDim.x + 31) >> 5); ++k) s += red[k];
    __syncthreads();
    return s;
  };
  const float msum = block_sum(own ? mean : 0.f);
  if (tid == 0) mm = msum / C;
  __syncthreads();
  const float d = own ? mean - mm : 0.f;
  const float vsum = block_sum(d * d);
  if (tid == 0) rv = rsqrtf(vsum / (C - 1) + 1e-5f);
  __syncthreads();
  if (own) {
    const float g = to_f32(gamma[c]);
    float* o = stat + (size_t)b * 3 * C;
    o[c] = mean;
    o[C + c] = g * rsqrtf(m2 / HW + 1e-5f);
    o[2 * C + c] = g * to_f32(alpha[c]) * ((mean - mm) * rv) +
                   to_f32(beta[c]);
  }
}

// grid (ceil(vectors / (kApplyThreads * kApplyVecs)), B): each thread
// normalizes kApplyVecs 8-channel vectors of a sample, 16-byte loads and
// stores, a block's vectors contiguous.
template <typename T>
__global__ void __launch_bounds__(kApplyThreads)
    instance_norm_plus_apply_kernel(const T* __restrict__ x,
                                    const float* __restrict__ stat,
                                    T* __restrict__ out, int HW, int C,
                                    int elu) {
  const int cv = C / 8, b = blockIdx.y;
  const size_t nv = (size_t)HW * cv;
  const float* st = stat + (size_t)b * 3 * C;
  const size_t v0 = (size_t)blockIdx.x * kApplyThreads * kApplyVecs;
#pragma unroll
  for (int k = 0; k < kApplyVecs; ++k) {
    const size_t v = v0 + (size_t)k * kApplyThreads + threadIdx.x;
    if (v >= nv) break;
    const int ci = 8 * (int)(v % cv);
    const size_t off = (size_t)b * HW * C + v * 8;
    float f[8];
    load8(x + off, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float y = (f[e] - st[ci + e]) * st[C + ci + e] + st[2 * C + ci + e];
      f[e] = elu ? apply_elu<T>(y) : y;
    }
    store8(out + off, f);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* alpha, const void* gamma,
                   const void* beta, void* out, float* part, float* stat,
                   int B, int HW, int C, int elu, int rows, int tiles,
                   cudaStream_t s) {
  const int cv = C / 8, TP = rows * kNP;
  const size_t smem = ((size_t)rows * C + C) * sizeof(float);
  instance_norm_plus_stats_kernel<T><<<dim3(tiles, B), rows * cv, smem, s>>>(
      static_cast<const T*>(x), part, HW, C, rows, tiles);
  const int parts = kFinalThreads / C;  // C <= 512: at least two
  instance_norm_plus_finalize_kernel<T><<<B, (parts * C + 31) / 32 * 32, 0,
                                          s>>>(
      part, static_cast<const T*>(alpha), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), stat, HW, C, TP, tiles);
  const size_t nv = (size_t)HW * cv;
  const unsigned ab =
      (unsigned)((nv + kApplyThreads * kApplyVecs - 1) /
                 (kApplyThreads * kApplyVecs));
  instance_norm_plus_apply_kernel<T><<<dim3(ab, B), kApplyThreads, 0, s>>>(
      static_cast<const T*>(x), stat, static_cast<T*>(out), HW, C, elu);
  return cudaGetLastError();
}

}  // namespace

// The two-pass route, with the plan of kernels/instance_norm.py::
// two_pass_plan: `rows` pixel rows a stats block (rows * C / 8 threads),
// `tiles` stats blocks a sample; part is (B, tiles, 2, C) f32 and stat
// (B, 3, C) f32 of workspace. x and out 16-byte aligned, C a multiple of 8.
extern "C" int sbc_instance_norm_plus_two_pass(
    const void* x, const void* alpha, const void* gamma, const void* beta,
    void* out, void* part, void* stat, int B, int HW, int C, int elu,
    int bf16, int rows, int tiles, void* stream) {
  if (C < 8 || C > kMaxC || C % 8 != 0 || B < 1 || HW < 1 || rows < 1 ||
      rows * (C / 8) > kStatsThreads || tiles != (HW + rows * kNP - 1) /
                                                     (rows * kNP))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  float* sf = static_cast<float*>(stat);
  return (int)(bf16 ? launch<__nv_bfloat16>(x, alpha, gamma, beta, out, pf,
                                            sf, B, HW, C, elu, rows, tiles,
                                            s)
                    : launch<float>(x, alpha, gamma, beta, out, pf, sf, B,
                                    HW, C, elu, rows, tiles, s));
}
