// 5x5 stride-1 max pooling with padding 2 (MaxPool2d(5, 1, 2)) of
// channels-last activations: the CRP blocks' pools
// (models/layers.py::max_pool_5x5) where autograd records nothing, which is
// every sampler's forward.
//
// Replaces no Pallas kernel: the JAX package pools with its framework's
// max_pool (XLA's reduce_window). Added because PyTorch's max_pool2d on channels-last
// input (max_pool_forward_nhwc) ran at 3-6% of its bytes bound and took a
// fifth of a bf16 sampler sweep; it visits all 25 taps of every output and
// writes int64 argmax indices that no caller under no_grad reads.
//
// Layouts: x and y are (B, H, W, C) in memory (NCHW tensors in
// channels_last), bf16 or f32, C times the element size a multiple of 16
// bytes: V 16-byte vectors a pixel; x and y 16-byte aligned.
//
// Bound on an H100: bytes, one read of x and one write of y (the 12 pools
// of a 64x16 bf16 forward at batch 256 move 101 MB, 0.030 ms at
// 3.35 TB/s; an FFHQ forward at batch 8 805 MB, 0.24 ms). A maximum costs
// no arithmetic to speak of.
//
// Design: a block owns one sample's band of TH = S x R rows, a range of TW
// columns and a group of VG of the pixel's vectors. It copies the band's
// pixels inside the image, with their 2-pixel halo, into shared memory by
// 16-byte cp.async (one wait, one barrier), so each input byte comes from
// device memory once (a halo again, mostly from L2). A thread owns one
// (column, vector) of one of the block's S sub-bands of R rows: it walks
// down its sub-band and the halo, takes each row's 5-wide maximum from
// shared memory, keeps the last five in registers, writes each output row as
// the maximum of five by a 16-byte store. A tap outside the image reads the
// nearest pixel inside it instead (clamped coordinates): that pixel is in
// the same window, so the maximum is the in-image taps' one, as with -inf
// padding, and no fill is needed. kernels/max_pool.py::launch_plan sizes
// the launch from (B, H, W, C, dtype).
//
// Numbers: max.NaN (bf16x2 or f32): a window with a NaN gives NaN, as
// F.max_pool2d does; otherwise the result is one of the window's inputs. So
// the kernel equals the library bit for bit, up to the sign of a zero where
// +0 and -0 tie and the bits of a NaN (the canonical NaN here, the input's
// NaN there).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;

template <bool BF16>
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  if constexpr (BF16) {
    uint32_t d;
    asm("max.NaN.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n"
      : "=f"(d)
      : "f"(__uint_as_float(a)), "f"(__uint_as_float(b)));
  return __float_as_uint(d);
}

template <bool BF16>
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(max2<BF16>(a.x, b.x), max2<BF16>(a.y, b.y),
                    max2<BF16>(a.z, b.z), max2<BF16>(a.w, b.w));
}

// grid: B x groups x col_blocks x bands blocks, the band fastest (blocks
// that share halo rows run together); block: VG x TW x S threads, the
// vector fastest
template <int VG, bool BF16>
__global__ void __launch_bounds__(kMaxThreads)
    max_pool5_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                     int H, int W, int V, int TW, int S, int R, int bands,
                     int col_blocks, int groups) {
  extern __shared__ uint4 tile[];
  const int TH = S * R;
  int t = blockIdx.x;
  const int band = t % bands;
  t /= bands;
  const int cb = t % col_blocks;
  t /= col_blocks;
  const int grp = t % groups;
  const int b = t / groups;
  const int h0 = band * TH, w0 = cb * TW;
  // the tile: rows [r_lo, r_hi) and columns [c_lo, c_hi) of the image
  const int r_lo = max(h0 - 2, 0), r_hi = min(h0 + TH + 2, H);
  const int c_lo = max(w0 - 2, 0), c_hi = min(w0 + TW + 2, W);
  const int tc = c_hi - c_lo;
  const size_t img = (size_t)b * H * W;
  const uint4* src = x + img * V + grp * VG;
  const int n = (r_hi - r_lo) * tc * VG;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int p = i / VG;
    const int r = r_lo + p / tc, c = c_lo + p % tc;
    sm90::cp_async16(tile + i, src + ((size_t)r * W + c) * V + i % VG, 16);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait(0);
  __syncthreads();

  const int v = threadIdx.x % VG, q = threadIdx.x / VG;
  const int w = w0 + q % TW, hs = h0 + (q / TW) * R;
  if (w >= W || hs >= H) return;  // no barrier follows
  const int he = min(hs + R, H);
  int off[5];  // the five taps' places in a tile row, clamped to the image
#pragma unroll
  for (int k = 0; k < 5; ++k)
    off[k] = (min(max(w - 2 + k, 0), W - 1) - c_lo) * VG + v;
  const int row_len = tc * VG;
  auto row_max = [&](int r) {
    const uint4* row = tile + (min(max(r, 0), H - 1) - r_lo) * row_len;
    return vmax<BF16>(vmax<BF16>(vmax<BF16>(row[off[0]], row[off[1]]),
                                 vmax<BF16>(row[off[2]], row[off[3]])),
                      row[off[4]]);
  };
  uint4 m0 = row_max(hs - 2), m1 = row_max(hs - 1), m2 = row_max(hs),
        m3 = row_max(hs + 1);
  uint4* dst = y + (img + (size_t)hs * W + w) * V + grp * VG + v;
  const size_t step = (size_t)W * V;
  for (int h = hs; h < he; ++h, dst += step) {
    const uint4 m4 = row_max(h + 2);
    *dst = vmax<BF16>(vmax<BF16>(vmax<BF16>(m0, m1), vmax<BF16>(m2, m3)), m4);
    m0 = m1;
    m1 = m2;
    m2 = m3;
    m3 = m4;
  }
}

template <int VG, bool BF16>
cudaError_t launch(const void* x, void* y, int blocks, int threads, int smem,
                   int H, int W, int V, int TW, int S, int R, int bands,
                   int col_blocks, int groups, cudaStream_t s) {
  auto kernel = max_pool5_kernel<VG, BF16>;
  static int smem_set = 0;  // the largest size this kernel was opted in to
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kernel<<<blocks, threads, smem, s>>>(static_cast<const uint4*>(x),
                                       static_cast<uint4*>(y), H, W, V, TW, S,
                                       R, bands, col_blocks, groups);
  return cudaGetLastError();
}

}  // namespace

// The launch of kernels/max_pool.py::launch_plan: V 16-byte vectors a
// pixel, bf16 or f32; blocks of vg vectors x tw columns x sub sub-bands of
// `rows` rows each; smem bytes (at least the largest block's tile).
extern "C" int sbc_max_pool5(const void* x, void* y, int B, int H, int W,
                             int V, int bf16, int vg, int tw, int sub,
                             int rows, int smem, void* stream) {
  if (B < 1 || H < 1 || W < 1 || V < 1 || tw < 1 || sub < 1 || rows < 1 ||
      (vg != 1 && vg != 2 && vg != 4 && vg != 8) || V % vg != 0)
    return (int)cudaErrorInvalidValue;
  const long long threads = (long long)vg * tw * sub;
  const long long th = (long long)sub * rows;
  const long long need = std::min<long long>(H, th + 4) *
                         std::min<long long>(W, tw + 4) * vg * 16;
  const long long bands = (H + th - 1) / th, col_blocks = (W + tw - 1) / tw,
                  groups = V / vg;
  const long long blocks = (long long)B * groups * col_blocks * bands;
  if (threads > kMaxThreads || smem < need || smem > kMaxSmem ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SBC_POOL_LAUNCH(VG, BF)                                               \
  return (int)launch<VG, BF>(x, y, (int)blocks, (int)threads, smem, H, W, V, \
                             tw, sub, rows, (int)bands, (int)col_blocks,     \
                             (int)groups, s)
#define SBC_POOL_VG(BF)              \
  switch (vg) {                      \
    case 1: SBC_POOL_LAUNCH(1, BF);  \
    case 2: SBC_POOL_LAUNCH(2, BF);  \
    case 4: SBC_POOL_LAUNCH(4, BF);  \
    default: SBC_POOL_LAUNCH(8, BF); \
  }
  if (bf16) SBC_POOL_VG(true);
  SBC_POOL_VG(false);
#undef SBC_POOL_VG
#undef SBC_POOL_LAUNCH
  return (int)cudaErrorInvalidValue;  // not reached
}
