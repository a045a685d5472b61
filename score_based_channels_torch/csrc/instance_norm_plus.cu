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
// Bound on an H100: bytes. One read and one write of the activation (about
// 335 MB for the 25 norms of one forward at batch 256 in bf16, 0.100 ms at
// 3.35 TB/s); the arithmetic is ~12 flops an element.
//
// Design: each activation byte is read from device memory once and each
// output byte written once, and many bytes are in flight. One sample a
// block (or a cluster); two routes, the plan's choice
// (kernels/instance_norm.py::plan):
//  - shared-memory route (64x16 and 32x8 samples, 16-128 KB): a sample is
//    contiguous in channels-last memory, so a block brings it into shared
//    memory by up to four 1-D bulk copies (cp.async.bulk, each completing
//    on its own mbarrier) and starts the per-channel sums on the first
//    while the others land; then the squared deviations (two-pass
//    variance: the Pallas kernel's E[x^2] - mu^2 cancels), each thread
//    holding 8 channels of a pixel (16-byte shared loads) over a strided
//    set of pixels; a reduction is warp shuffles plus one shared step. One
//    warp forms the channel-mean statistics and the per-channel scale and
//    shift; the block normalizes in place in shared memory and each chunk
//    leaves by one bulk store (cp.async.bulk.global.shared::cta after
//    fence.proxy.async) while the next is normalized. A sample too large
//    for one block's shared memory is split across a thread-block cluster
//    of 2-8 blocks, each holding a range of pixels; the blocks add each
//    other's per-channel partial sums through distributed shared memory.
//    Only such samples take a cluster: at 64x16 c32 in f32 (128 KB, one
//    block an SM) a 2-block cluster measured slower than one block with
//    four chunks, whose later loads already overlap the earlier blocks'
//    stores.
//  - register route (16x4 and 8x2 samples, at most 8 vectors a thread):
//    16-byte loads straight into registers, the same statistics, 16-byte
//    stores. A bulk copy's round trip through shared memory costs these
//    more than their bytes.
// Samples whose byte size is not a multiple of 16 take element loads and
// stores through shared memory, and a channel count that is not a
// multiple of 8 one channel per thread. A bulk copy or 16-byte access that
// the plan asks for and the pointers cannot take (unaligned) is an error,
// never a slower form. ELU is expm1f in f32, as F.elu and the JAX
// reference compute it; in bf16 it is __expf(y) - 1, within 2e-7 absolute
// of expm1f (far below bf16's rounding) at a fifth of its instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxC = 128;
constexpr int kMaxThreads = 512;     // a block of the shared-memory route
constexpr int kMaxRegThreads = 128;  // a block of the register route
constexpr int kMaxCluster = 8;
constexpr int kMaxChunks = 4;        // bulk copies in flight a block
constexpr int kMaxSmem = 232448;
constexpr int kCopyElement = 0, kCopyBulk = 1, kCopyRegs = 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive channels of one pixel, in shared memory, as floats
template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 8> {
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};
template <typename T>
struct Vec<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float* f) {
    f[0] = to_f32(*p);
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *p = f[0];
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    *p = __float2bfloat16(f[0]);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ELU: expm1f in f32; __expf(y) - 1 in bf16, whose rounding hides it
template <typename T>
__device__ __forceinline__ float apply_elu(float y) {
  if (y > 0.f) return y;
  return sizeof(T) == 4 ? expm1f(y) : __expf(y) - 1.f;
}

// Shared memory of one block (the same sums as kernels/instance_norm.py::
// smem_bytes): its sample (or the cluster's pixel range of one; none on
// the register route), the reduction slots (ns of C floats), five C-float
// arrays (partial sums, partial squared deviations, means, scales,
// shifts), alpha/gamma/beta as f32, and the mbarriers.
struct Layout {
  int cvp, ns;
  size_t red, stats, params, bar, bytes;
  __host__ __device__ Layout(int ts, int hwc, int C, int V, int es,
                             bool regs) {
    cvp = 1;
    while (cvp < C / V) cvp <<= 1;
    ns = ts / (cvp > 32 ? cvp : 32);
    red = regs ? 0 : ((size_t)hwc * C * es + 15) / 16 * 16;
    stats = red + (size_t)ns * C * 4;
    params = stats + (size_t)5 * C * 4;
    bar = (params + (size_t)3 * C * 4 + 15) / 16 * 16;
    bytes = bar + 8 * kMaxChunks;
  }
};

template <typename T>
__device__ __forceinline__ void load_params(const T* alpha, const T* gamma,
                                            const T* beta, float* p, int C) {
  for (int k = threadIdx.x; k < C; k += blockDim.x) {
    p[k] = to_f32(alpha[k]);
    p[C + k] = to_f32(gamma[k]);
    p[2 * C + k] = to_f32(beta[k]);
  }
}

// Per-channel sums of acc over the block's threads, into dst[c]: shuffles
// across the lanes of a warp that share a channel group, one slot a warp
// (or a pixel row, when a row spans whole warps) in shared memory, then a
// sum over the slots.
template <int V>
__device__ __forceinline__ void reduce_channels(float* acc, float* red,
                                                float* dst, int C, int cvp,
                                                int ns) {
  const int tid = threadIdx.x, cg = tid % cvp;
  if (cvp < 32) {
    for (int o = 16; o >= cvp; o >>= 1) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
    }
  }
  const int w = cvp > 32 ? cvp : 32;
  if (tid % w < cvp && cg < C / V) {
    float* r = red + (size_t)(tid / w) * C + cg * V;
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = acc[v];
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float sum = 0.f;
    for (int k = 0; k < ns; ++k) sum += red[(size_t)k * C + c];
    dst[c] = sum;
  }
}

// Warp 0: the mean and unbiased variance of the channel means, then the
// per-channel scale (on entry 1/sqrt(var + eps)) and shift.
__device__ __forceinline__ void sample_stats(const float* mean, float* scale,
                                             float* shift, const float* p,
                                             int C) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  float m = 0.f;
  for (int k = lane; k < C; k += 32) m += mean[k];
  m = warp_sum(m) / C;
  float var = 0.f;
  for (int k = lane; k < C; k += 32) {
    const float d = mean[k] - m;
    var += d * d;
  }
  const float rv = rsqrtf(warp_sum(var) / (C - 1) + 1e-5f);
  for (int k = lane; k < C; k += 32) {
    const float m_hat = (mean[k] - m) * rv;
    const float gk = p[C + k];
    scale[k] = gk * scale[k];
    shift[k] = gk * p[k] * m_hat + p[2 * C + k];
  }
}

// Shared-memory route. grid: B blocks (cluster == 1), or B clusters of
// `cluster` blocks, block r of a cluster holding pixels
// [r * hwc, min((r + 1) * hwc, HW)) of its sample. The block's range comes
// in `nch` chunks, each a bulk copy on its own mbarrier, and leaves in the
// same chunks.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    instance_norm_plus_kernel(const T* __restrict__ x,
                              const T* __restrict__ alpha,
                              const T* __restrict__ gamma,
                              const T* __restrict__ beta,
                              T* __restrict__ out, int HW, int C, int elu,
                              int cluster, int hwc, int bulk, int nch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, ts = blockDim.x;
  const Layout L(ts, hwc, C, V, sizeof(T), false);
  T* data = reinterpret_cast<T*>(smem);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* psum = reinterpret_cast<float*>(smem + L.stats);
  float* psq = psum + C;
  float* mean = psq + C;
  float* scale = mean + C;
  float* shift = scale + C;
  float* params = reinterpret_cast<float*>(smem + L.params);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);

  int b = blockIdx.x, p0 = 0, np = HW;
  if (cluster > 1) {
    b = blockIdx.x / cluster;
    p0 = sm90::cluster_rank() * hwc;
    np = min(hwc, HW - p0);
  }
  const size_t base = ((size_t)b * HW + p0) * C;
  const size_t count = (size_t)np * C;  // contiguous in x and out

  // thread t holds channels [cg * V, cg * V + V) of pixels g, g + G, ... of
  // the range; chunk k is pixels [k * pc, (k + 1) * pc)
  const int cvp = L.cvp, cg = tid % cvp, g = tid / cvp, G = ts / cvp;
  const int pc = nch == 1 ? np : ((hwc + nch - 1) / nch + G - 1) / G * G;
  auto chunk_elems = [&](int k) -> size_t {  // elements of chunk k
    return nch == 1 ? count
                    : (size_t)max(0, min(np, (k + 1) * pc) - k * pc) * C;
  };

  // (1) the sample (or pixel range) into shared memory, once
  if (bulk) {
    if (tid == 0) {
      for (int k = 0; k < nch; ++k) sm90::mbar_init(bar + k, 1);
      sm90::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (int k = 0; k < nch; ++k) {
        const uint32_t bytes = (uint32_t)(chunk_elems(k) * sizeof(T));
        sm90::mbar_arrive_expect_tx(bar + k, bytes);
        if (bytes)
          sm90::bulk_load(data + (size_t)k * pc * C, x + base + (size_t)k * pc * C,
                          bytes, bar + k);
      }
    }
    load_params(alpha, gamma, beta, params, C);
  } else {
    load_params(alpha, gamma, beta, params, C);
    for (size_t i = tid; i < count; i += blockDim.x) data[i] = x[base + i];
    __syncthreads();
  }

  const bool live = cg < C / V;
  const int npix = live ? np : 0;
  T* xs = data + cg * V;
  const int ci = cg * V;  // this thread's first channel

  // (2) per-channel means, chunk by chunk as the copies land
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int k = 0; k < nch; ++k) {
    if (bulk) sm90::mbar_wait(bar + k, 0);
    const int end = min(npix, (k + 1) * pc);
    for (int p = k * pc + g; p < end; p += G) {
      float f[V];
      Vec<T, V>::load(xs + (size_t)p * C, f);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += f[v];
    }
  }
  reduce_channels<V>(acc, red, psum, C, cvp, L.ns);
  if (cluster > 1)
    sm90::cluster_sync();
  else
    __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float sum = psum[c];
    if (cluster > 1) {
      sum = 0.f;
      for (int r = 0; r < cluster; ++r) sum += sm90::ld_peer(psum + c, r);
    }
    mean[c] = sum / HW;
  }
  __syncthreads();

  // (3) per-channel biased variances, from the deviations
  float mu[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mu[v] = live ? mean[ci + v] : 0.f;
    acc[v] = 0.f;
  }
  for (int p = g; p < npix; p += G) {
    float f[V];
    Vec<T, V>::load(xs + (size_t)p * C, f);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = f[v] - mu[v];
      acc[v] += d * d;
    }
  }
  reduce_channels<V>(acc, red, psq, C, cvp, L.ns);
  if (cluster > 1)
    sm90::cluster_sync();
  else
    __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    float q = psq[c];
    if (cluster > 1) {
      q = 0.f;
      for (int r = 0; r < cluster; ++r) q += sm90::ld_peer(psq + c, r);
    }
    scale[c] = rsqrtf(q / HW + 1e-5f);  // 1/sqrt(biased var + eps)
  }
  if (cluster > 1) sm90::cluster_arrive();  // done with the peers' sums
  __syncthreads();

  // (4) warp 0: the sample's scale and shift
  sample_stats(mean, scale, shift, params, C);
  __syncthreads();

  // (5) normalize in place, chunk by chunk, each chunk stored once
  float sc[V], sh[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sc[v] = live ? scale[ci + v] : 0.f;
    sh[v] = live ? shift[ci + v] : 0.f;
  }
  for (int k = 0; k < nch; ++k) {
    const int end = min(npix, (k + 1) * pc);
    for (int p = k * pc + g; p < end; p += G) {
      float f[V];
      Vec<T, V>::load(xs + (size_t)p * C, f);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float y = (f[v] - mu[v]) * sc[v] + sh[v];
        f[v] = elu ? apply_elu<T>(y) : y;
      }
      Vec<T, V>::store(xs + (size_t)p * C, f);
    }
    if (bulk) {
      sm90::fence_proxy_async();
      __syncthreads();
      const uint32_t bytes = (uint32_t)(chunk_elems(k) * sizeof(T));
      if (tid == 0 && bytes) {
        sm90::bulk_store(out + base + (size_t)k * pc * C,
                         data + (size_t)k * pc * C, bytes);
        sm90::bulk_commit();
      }
    }
  }
  if (bulk) {
    if (tid == 0) sm90::bulk_wait_read<0>();  // shared memory stays till read
  } else {
    __syncthreads();
    for (size_t i = tid; i < count; i += blockDim.x) out[base + i] = data[i];
  }
  if (cluster > 1) sm90::cluster_wait();  // no peer still reads our sums
}

// Register route, for samples of at most NP 8-channel vectors a thread:
// 16-byte loads straight into registers and 16-byte stores out, no shared
// copy of the data. grid: B blocks.
template <typename T, int NP>
__global__ void __launch_bounds__(kMaxRegThreads)
    instance_norm_plus_regs_kernel(const T* __restrict__ x,
                                   const T* __restrict__ alpha,
                                   const T* __restrict__ gamma,
                                   const T* __restrict__ beta,
                                   T* __restrict__ out, int HW, int C,
                                   int elu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const Layout L(blockDim.x, 0, C, 8, sizeof(T), true);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* psum = reinterpret_cast<float*>(smem + L.stats);
  float* psq = psum + C;
  float* mean = psq + C;
  float* scale = mean + C;
  float* shift = scale + C;
  float* params = reinterpret_cast<float*>(smem + L.params);

  const int cvp = L.cvp, cg = tid % cvp, g = tid / cvp, G = blockDim.x / cvp;
  const bool live = cg < C / 8;
  const size_t off = (size_t)blockIdx.x * HW * C + cg * 8;
  const int ci = cg * 8;

  float f[NP][8];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = g + i * G;
    if (live && p < HW) {
      Vec<T, 8>::load(x + off + (size_t)p * C, f[i]);
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) f[i][v] = 0.f;
    }
  }
  load_params(alpha, gamma, beta, params, C);

  float acc[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    acc[v] = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[v] += f[i][v];
  }
  reduce_channels<8>(acc, red, psum, C, cvp, L.ns);
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) mean[c] = psum[c] / HW;
  __syncthreads();

  float mu[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    mu[v] = live ? mean[ci + v] : 0.f;
    acc[v] = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float d = g + i * G < HW ? f[i][v] - mu[v] : 0.f;
      acc[v] += d * d;
    }
  }
  reduce_channels<8>(acc, red, psq, C, cvp, L.ns);
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x)
    scale[c] = rsqrtf(psq[c] / HW + 1e-5f);
  __syncthreads();
  sample_stats(mean, scale, shift, params, C);
  __syncthreads();

  if (!live) return;
  float sc[8], sh[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) sc[v] = scale[ci + v], sh[v] = shift[ci + v];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = g + i * G;
    if (p < HW) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const float y = (f[i][v] - mu[v]) * sc[v] + sh[v];
        f[i][v] = elu ? apply_elu<T>(y) : y;
      }
      Vec<T, 8>::store(out + off + (size_t)p * C, f[i]);
    }
  }
}

// opts a kernel in to `smem` dynamic shared bytes (above the default 48 KB)
// and to the largest shared-memory carveout, once per size
template <typename K>
cudaError_t opt_in(K kernel, int smem, int* set) {
  if (smem <= 48 * 1024 || smem <= *set) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) *set = smem;
  return e;
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* alpha, const void* gamma,
                   const void* beta, void* out, int B, int HW, int C, int elu,
                   int ts, int cluster, int hwc, int bulk, int nch, int smem,
                   cudaStream_t s) {
  auto kernel = instance_norm_plus_kernel<T, V>;
  static int smem_set = 0;
  cudaError_t e = opt_in(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  const T* xt = static_cast<const T*>(x);
  const T* at = static_cast<const T*>(alpha);
  const T* gt = static_cast<const T*>(gamma);
  const T* bt = static_cast<const T*>(beta);
  T* ot = static_cast<T*>(out);
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * cluster);
    cfg.blockDim = dim3(ts);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, xt, at, gt, bt, ot, HW, C, elu,
                           cluster, hwc, bulk, nch);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  kernel<<<B, ts, smem, s>>>(xt, at, gt, bt, ot, HW, C, elu, cluster, hwc,
                             bulk, nch);
  return cudaGetLastError();
}

template <typename T, int NP>
cudaError_t launch_regs(const void* x, const void* alpha, const void* gamma,
                        const void* beta, void* out, int B, int HW, int C,
                        int elu, int ts, int smem, cudaStream_t s) {
  auto kernel = instance_norm_plus_regs_kernel<T, NP>;
  static int smem_set = 0;
  const cudaError_t e = opt_in(kernel, smem, &smem_set);
  if (e != cudaSuccess) return e;
  kernel<<<B, ts, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(alpha),
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(out), HW, C, elu);
  return cudaGetLastError();
}

}  // namespace

// The launch of kernels/instance_norm.py::plan: a block of ts threads a
// sample, or `cluster` blocks a sample of hwc pixels each; V channels per
// thread (8 or 1); copy 0 (element), 1 (bulk, in nch chunks) or 2 (16-byte
// loads into registers); smem bytes.
extern "C" int sbc_instance_norm_plus(const void* x, const void* alpha,
                                      const void* gamma, const void* beta,
                                      void* out, int B, int HW, int C,
                                      int elu, int bf16, int ts, int cluster,
                                      int hwc, int V, int copy, int nch,
                                      int smem, void* stream) {
  const int es = bf16 ? 2 : 4;
  const bool regs = copy == kCopyRegs;
  if (C < 2 || C > kMaxC || B < 1 || HW < 1 || (V != 1 && V != 8) ||
      C % V != 0 || ts < 32 || ts % 32 != 0 ||
      ts > (regs ? kMaxRegThreads : kMaxThreads) || cluster < 1 ||
      cluster > kMaxCluster || (cluster == 1 && hwc != HW) || copy < 0 ||
      copy > kCopyRegs ||
      (cluster > 1 && ((cluster - 1) * hwc >= HW || cluster * hwc < HW)) ||
      nch < 1 || nch > kMaxChunks || (nch > 1 && (V != 8 || copy != kCopyBulk)))
    return (int)cudaErrorInvalidValue;
  const Layout L(ts, hwc, C, V, es, regs);
  if (ts % L.cvp != 0 || (size_t)smem < L.bytes || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (copy != kCopyElement) {
    // the plan asked for bulk copies or 16-byte loads: whole 16-byte
    // pieces at 16-byte aligned addresses, or an error (never a slower
    // form)
    if (((size_t)HW * C * es) % 16 != 0 || ((size_t)hwc * C * es) % 16 != 0 ||
        (regs && (V != 8 || cluster != 1)))
      return (int)cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regs) {
    const int np = (HW + ts / L.cvp - 1) / (ts / L.cvp);  // vectors a thread
#define SBC_NORM_REGS(T)                                                   \
  if (np <= 1)                                                             \
    return (int)launch_regs<T, 1>(x, alpha, gamma, beta, out, B, HW, C, elu, \
                                  ts, smem, s);                            \
  if (np <= 2)                                                             \
    return (int)launch_regs<T, 2>(x, alpha, gamma, beta, out, B, HW, C, elu, \
                                  ts, smem, s);                            \
  if (np <= 4)                                                             \
    return (int)launch_regs<T, 4>(x, alpha, gamma, beta, out, B, HW, C, elu, \
                                  ts, smem, s);                            \
  if (np <= 8)                                                             \
    return (int)launch_regs<T, 8>(x, alpha, gamma, beta, out, B, HW, C, elu, \
                                  ts, smem, s);                            \
  return (int)cudaErrorInvalidValue
    if (bf16) {
      SBC_NORM_REGS(__nv_bfloat16);
    }
    SBC_NORM_REGS(float);
#undef SBC_NORM_REGS
  }
  const int bulk = copy == kCopyBulk;
#define SBC_NORM_LAUNCH(T, VV)                                             \
  return (int)launch<T, VV>(x, alpha, gamma, beta, out, B, HW, C, elu, ts, \
                            cluster, hwc, bulk, nch, smem, s)
  if (bf16) {
    if (V == 8) SBC_NORM_LAUNCH(__nv_bfloat16, 8);
    SBC_NORM_LAUNCH(__nv_bfloat16, 1);
  }
  if (V == 8) SBC_NORM_LAUNCH(float, 8);
  SBC_NORM_LAUNCH(float, 1);
#undef SBC_NORM_LAUNCH
}
