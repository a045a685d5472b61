// InstanceNorm++ with an optional fused ELU, channels-last.
//
// Replaces the JAX package's kernels/instance_norm.py::
// instance_norm_plus_pallas (one grid step per sample: per-channel spatial
// mean and biased variance, mean and UNBIASED variance of the channel
// means, gamma*((x - mu)/sqrt(var + 1e-5) + alpha*m_hat) + beta, optional
// ELU).
//
// Layouts: x and out are (B, H*W, C) in memory (PyTorch NCHW tensors in
// torch.channels_last), f32 or bf16; alpha, gamma, beta are (C,) in the
// same dtype. Statistics are f32.
//
// Bound on an H100: memory.  One read and one write of the activation
// (about 335 MB for the 25 norms of one forward at batch 256 in bf16,
// ~0.1 ms at 3.35 TB/s).  Design: one block per sample (the largest sample,
// 64x16x32 in f32, is 128 KB and stays in L1/L2 across the passes); thread
// t owns channel t % C and every G-th pixel, G = blockDim / C, so a warp
// reads consecutive channels of one pixel.  Pass 1 sums per channel, pass 2
// sums (x - mu)^2 (two-pass variance: the Pallas kernel's E[x^2] - mu^2
// cancels), then one warp forms the channel-mean statistics and the
// per-channel scale and shift, and pass 3 writes the normalised, shifted,
// optionally ELU'd value once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxC = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    instance_norm_plus_kernel(const T* __restrict__ x,
                              const T* __restrict__ alpha,
                              const T* __restrict__ gamma,
                              const T* __restrict__ beta,
                              T* __restrict__ out, int HW, int C, int elu) {
  __shared__ float red[kThreads];
  __shared__ float mean_s[kMaxC];
  __shared__ float scale_s[kMaxC];
  __shared__ float shift_s[kMaxC];

  const int tid = threadIdx.x;
  const int G = blockDim.x / C;  // lanes per channel; blockDim == G * C
  const int c = tid % C;
  const int g = tid / C;
  const size_t base = (size_t)blockIdx.x * HW * C;
  const T* xb = x + base;
  T* ob = out + base;

  float s = 0.f;
  for (int p = g; p < HW; p += G) s += to_f32(xb[(size_t)p * C + c]);
  red[tid] = s;
  __syncthreads();
  if (tid < C) {
    float t = 0.f;
    for (int k = 0; k < G; ++k) t += red[k * C + tid];
    mean_s[tid] = t / HW;
  }
  __syncthreads();

  const float mu = mean_s[c];
  float q = 0.f;
  for (int p = g; p < HW; p += G) {
    const float d = to_f32(xb[(size_t)p * C + c]) - mu;
    q += d * d;
  }
  red[tid] = q;
  __syncthreads();
  if (tid < C) {
    float t = 0.f;
    for (int k = 0; k < G; ++k) t += red[k * C + tid];
    scale_s[tid] = rsqrtf(t / HW + 1e-5f);  // 1/sqrt(biased var + eps)
  }
  __syncthreads();

  if (tid < 32) {
    float m = 0.f;
    for (int k = tid; k < C; k += 32) m += mean_s[k];
    m = warp_sum(m) / C;
    float v = 0.f;
    for (int k = tid; k < C; k += 32) {
      const float d = mean_s[k] - m;
      v += d * d;
    }
    const float rv = rsqrtf(warp_sum(v) / (C - 1) + 1e-5f);
    for (int k = tid; k < C; k += 32) {
      const float m_hat = (mean_s[k] - m) * rv;
      const float gk = to_f32(gamma[k]);
      scale_s[k] = gk * scale_s[k];
      shift_s[k] = gk * to_f32(alpha[k]) * m_hat + to_f32(beta[k]);
    }
  }
  __syncthreads();

  const float sc = scale_s[c];
  const float sh = shift_s[c];
  for (int p = g; p < HW; p += G) {
    const size_t i = (size_t)p * C + c;
    float v = (to_f32(xb[i]) - mu) * sc + sh;
    if (elu) v = v > 0.f ? v : expm1f(v);
    store(ob + i, v);
  }
}

}  // namespace

extern "C" int sbc_instance_norm_plus(const void* x, const void* alpha,
                                      const void* gamma, const void* beta,
                                      void* out, int B, int HW, int C,
                                      int elu, int bf16, void* stream) {
  if (C < 2 || C > kMaxC || B < 1 || HW < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = (kThreads / C) * C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using bf = __nv_bfloat16;
    instance_norm_plus_kernel<bf><<<B, threads, 0, s>>>(
        static_cast<const bf*>(x), static_cast<const bf*>(alpha),
        static_cast<const bf*>(gamma), static_cast<const bf*>(beta),
        static_cast<bf*>(out), HW, C, elu);
  } else {
    instance_norm_plus_kernel<float><<<B, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(alpha),
        static_cast<const float*>(gamma), static_cast<const float*>(beta),
        static_cast<float*>(out), HW, C, elu);
  }
  return (int)cudaGetLastError();
}
