// 2x2 mean pooling (AvgPool2d(2)) of channels-last activations: the second
// half of ConvMeanPool and the U-Net's down-sampling
// (models/layers.py::mean_pool_2x2) where autograd records nothing, which is
// every sampler's forward.
//
// Replaces no Pallas kernel: the JAX package pools with its framework's
// reshape and mean. Added because PyTorch's avg_pool2d on channels-last input
// (avg_pool2d_out_cuda_frame_nhwc: one thread an element, 2-byte loads in
// bf16) ran at ~13% of its bytes bound and took 7% of a bf16 sampler sweep and
// of an FFHQ inpainting unit.
//
// Layouts: x is (B, H, W, C) in memory (an NCHW tensor in channels_last), H
// and W even, y is (B, H/2, W/2, C); bf16 or f32, C times the element size a
// multiple of 16 bytes: V 16-byte vectors a pixel; x and y 16-byte aligned.
//
// Bound on an H100: bytes, one read of x and one write of y, a quarter of it
// (the 6 pools of a 64x16 bf16 forward at batch 256 move 110 MB, 0.033 ms at
// 3.35 TB/s; an FFHQ forward at batch 8 881 MB, 0.263 ms). Four adds an
// output element cost nothing to speak of.
//
// Design: one thread an output vector. Neighbouring threads take
// neighbouring vectors of a pixel, then neighbouring output pixels, so a
// warp's load of one window tap covers whole 32-byte sectors and its store
// is one contiguous run. A thread issues its four 16-byte loads (two
// adjacent pixels of input row 2y, two of row 2y+1) before it adds, and
// stores once. The input is read with the streaming hint (ld.global.cs:
// evict-first in L1 and L2): in ConvMeanPool it is dead after the pool,
// and the quarter-size output, which the block's residual add reads next,
// should stay in L2 instead. kernels/mean_pool.py::launch_plan sizes the
// launch from (B, H, W, C, dtype).
//
// Numbers: as F.avg_pool2d (count_include_pad has no effect without
// padding): the window's sum in f32 from 0, in the library's order
// ((0 + x[2y][2x]) + x[2y][2x+1]) + x[2y+1][2x]) + x[2y+1][2x+1], then a
// quarter of it (exact: the library divides by 4), rounded once to the
// dtype (round to nearest even). So the output equals the library's bit
// for bit; adds by intrinsic, so that nothing folds the leading 0 + x away
// (it turns a -0 into +0, as the library's does).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.cs.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
  const float s = __fadd_rn(__fadd_rn(__fadd_rn(0.0f, a), b), c);
  return __fmul_rn(__fadd_rn(s, d), 0.25f);
}

// bf16 lanes of a 32-bit word: the low one first in memory
__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <bool BF16>
__device__ __forceinline__ uint32_t mean_word(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  if constexpr (BF16) {
    const float l = mean4(lo(a), lo(b), lo(c), lo(d));
    const float h = mean4(hi(a), hi(b), hi(c), hi(d));
    uint32_t r;  // upper half from the first source, lower from the second
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(h), "f"(l));
    return r;
  }
  return __float_as_uint(mean4(__uint_as_float(a), __uint_as_float(b),
                               __uint_as_float(c), __uint_as_float(d)));
}

// grid: ceil(n / blockDim.x) blocks, one thread an output vector, the
// vector fastest, then the output column, then the output row of a sample
// (samples follow one another: input row 2r of the (B H) rows is row 2y of
// sample r / (H/2))
template <bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    mean_pool2_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                      unsigned n, unsigned V, unsigned Wo) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned p = i / V, v = i - p * V;    // output pixel, vector
  const unsigned r = p / Wo, c = p - r * Wo;  // output row (of B H/2), col
  const size_t row = (size_t)2 * Wo * V;  // an input row's vectors
  const uint4* top = x + 2 * r * row + (size_t)2 * c * V + v;
  const uint4 a = load_stream(top), b = load_stream(top + V);
  const uint4 e = load_stream(top + row), f = load_stream(top + row + V);
  uint4 o;
  o.x = mean_word<BF16>(a.x, b.x, e.x, f.x);
  o.y = mean_word<BF16>(a.y, b.y, e.y, f.y);
  o.z = mean_word<BF16>(a.z, b.z, e.z, f.z);
  o.w = mean_word<BF16>(a.w, b.w, e.w, f.w);
  y[i] = o;
}

}  // namespace

// The launch of kernels/mean_pool.py::launch_plan: x (B, H, W, V 16-byte
// vectors), H and W even, bf16 or f32, `threads` a block, one thread an
// output vector; the input's vectors under 2^31.
extern "C" int sbc_mean_pool2(const void* x, void* y, int B, int H, int W,
                              int V, int bf16, int threads, void* stream) {
  if (B < 1 || H < 2 || W < 2 || V < 1 || H % 2 || W % 2 || threads < 32 ||
      threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long long in = (long long)B * H * W * V;
  if (in > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const unsigned n = (unsigned)(in / 4), Wo = (unsigned)(W / 2);
  const unsigned blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* src = static_cast<const uint4*>(x);
  uint4* dst = static_cast<uint4*>(y);
  if (bf16)
    mean_pool2_kernel<true><<<blocks, threads, 0, s>>>(src, dst, n, V, Wo);
  else
    mean_pool2_kernel<false><<<blocks, threads, 0, s>>>(src, dst, n, V, Wo);
  return (int)cudaGetLastError();
}
