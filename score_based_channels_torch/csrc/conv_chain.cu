// n chained (k x k dilated "same" conv -> + bias -> ELU) steps in one launch.
//
// Replaces the JAX package's kernels/conv_probe.py::conv_chain (:178, its
// pallas_call at :200): n steps of the per-tap conv with C input and C
// output channels, f32 accumulation, + bias, ELU, and a rounding to x's
// dtype after every step, with weights and activations resident in VMEM
// across the whole chain, so that nothing goes back to HBM between steps.
//
// Here a block owns SB whole samples (S = H*W pixels each) and keeps their
// activations in shared memory across all n steps, ping-ponging between two
// buffers; each buffer has one extra pixel row of zeros that a tap reaching
// past the image reads instead of the missing neighbour, so no inner loop
// tests bounds. Every step needs all C channels of the step before, so a
// block cannot split the output channels: the grid is B / SB blocks. Unlike
// the TPU's VMEM, a block's shared memory cannot hold the chain's weights
// (n = 8 3x3 layers of 128 x 128 are 2.36 MB in bf16), so they stream
// through it, read in place from the (n, k, k, C, C) tensor while the block
// computes on the part before. Dead taps are never visited. Two routes:
//
//  - bf16 with C a multiple of 16 (the probe's chain): the tensor cores,
//    mma.sync m16n8k16 (bf16 in, f32 accumulation). The activations live in
//    shared memory as bf16, [pixel][channel] with a 16-byte pad per row;
//    each lane of ldmatrix names one gathered row (the tap's shifted pixel,
//    or the zero row), so the shifted, masked patch is never built. The
//    weights stream one tap's (C, C) matrix (32 KB at C = 128) at a time
//    through a ring of four buffers, three taps in flight while the block
//    multiplies with the fourth. The blocks run in thread-block clusters
//    of CL, which share one weight stream: rank r of the cluster fetches
//    rows [r C / CL, (r + 1) C / CL) of each tap by 1-D bulk copies (one a
//    row, into the padded row) multicast to all CL blocks, so each tap
//    leaves L2 once a cluster. A slot's full mbarrier counts the tap's
//    bytes landing in this block; its empty mbarrier takes one arrival
//    from each block of the cluster once that block has read the slot, and
//    a rank issues into the slot again only when its own empty barrier has
//    all CL. CL = 1 is the same code with a mask of one block.
//    Each warp owns a 16-pixel x 32-channel tile of the output. Rounding an
//    f32 sum to bf16 between steps is what the Pallas kernel does, so the
//    bf16 activations lose nothing.
//  - otherwise (float32, or C not a multiple of 16): the FP32 FMA units,
//    activations as f32 [channel][pixel]; each thread keeps a 4-pixel x
//    4-channel f32 tile in registers; the weights stream in chunks of CK
//    input channels, four-wide loads prefetched into registers as raw
//    elements and converted when they are staged.
//
// Bound on an H100: at the probe's 8x2, C = 128, n = 8, batch 256 in bf16
// the chain is 9.66 GFLOP against ~4.5 MB of input, output and weights, so
// the operations bound it (>= 0.0098 ms on the bf16 tensor cores; in f32,
// >= 0.144 ms on the FMA units). The plan (kernels/conv_chain.py::plan)
// takes SB = B / 128 samples per block (2 at batch 256): 128 blocks fill
// all but 4 of the 132 SMs. Every block needs every tap (2.36 MB at n = 8),
// so without clusters the weights leave L2 128 times (~300 MB); a cluster
// of CL blocks divides those reads by CL, but not the bulk copies that a
// block receives: one a padded row, C a tap. On an H100 each costs the
// receiving SM some 30 ns whatever its size, so it is this stream, not L2
// nor the products, that limits the design (PERF.md): more samples per
// block or clusters of 4 or 8 (which the card cannot all hold at once at
// 128 blocks) do not change it. A tap that lands in one bulk copy needs a
// layout without the row pad (a swizzle, so that ldmatrix stays free of
// bank conflicts); that, and wgmma on the resident activations, is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxTaps = 9;
constexpr int TM = 4;    // FMA route: pixels per thread
constexpr int TN = 4;    // FMA route: output channels per thread
constexpr int PV = 4;    // FMA route: four-wide weight loads per thread/chunk
constexpr int kStages = 4;  // MMA route: weight ring slots

struct Taps {
  int n;
  int dy[kMaxTaps];
  int dx[kMaxTaps];
  int wi[kMaxTaps];  // tap index iy*k + ix into one step's weight
};

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float bias_at(const void* bs, int bs_bf16, int i) {
  return bs_bf16 ? __bfloat162float(static_cast<const bf16*>(bs)[i])
                 : static_cast<const float*>(bs)[i];
}
__device__ __forceinline__ float elu(float v) {
  return v > 0.f ? v : expm1f(v);
}

// four raw elements, converted to f32 only when they are staged, so that a
// load in flight is not waited for where it is issued
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  float4 v;
  __device__ float4 f32() const { return v; }
};
template <>
struct Raw4<bf16> {
  uint2 v;
  __device__ float4 f32() const {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
};
// up to four consecutive elements, those at or past `valid` zero; p is
// aligned to four elements when vec is set
__device__ __forceinline__ Raw4<float> load_raw4(const float* p, int valid,
                                                 int vec) {
  Raw4<float> r;
  if (valid >= 4 && vec) {
    r.v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    r.v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid > 0) r.v.x = p[0];
    if (valid > 1) r.v.y = p[1];
    if (valid > 2) r.v.z = p[2];
    if (valid > 3) r.v.w = p[3];
  }
  return r;
}
__device__ __forceinline__ Raw4<bf16> load_raw4(const bf16* p, int valid,
                                                int vec) {
  Raw4<bf16> r;
  if (valid >= 4 && vec) {
    r.v = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
    unsigned e[4] = {0u, 0u, 0u, 0u};
    for (int i = 0; i < 4 && i < valid; ++i) e[i] = u[i];
    r.v.x = e[0] | (e[1] << 16);
    r.v.y = e[2] | (e[3] << 16);
  }
  return r;
}

// ---------------------------------------------------------------------------
// FP32 FMA route
// ---------------------------------------------------------------------------

template <typename T>
__global__ void conv_chain_fma_kernel(const T* __restrict__ x,
                                      const T* __restrict__ ws,
                                      const void* __restrict__ bs, int bs_bf16,
                                      T* __restrict__ out, int n, int B, int H,
                                      int W, int C, int kk, long long xs_b,
                                      long long xs_h, long long xs_w,
                                      long long os_b, long long os_h,
                                      long long os_w, Taps taps, int SB,
                                      int CK, int wvec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = H * W;
  const int M = SB * S;        // pixels of the block
  const int MP = M + 1;        // + the zero row, index M
  const int Mg = (M + TM - 1) / TM;
  const int Cg = (C + TN - 1) / TN;
  const int CP = Cg * TN;      // staged weight row, zero padded
  float* act0 = smem;                              // [C][MP]
  float* act1 = smem + C * MP;                     // [C][MP]
  float* w_s = smem + ((2 * C * MP + 3) & ~3);     // [CK][CP]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * SB;

  // stage the block's samples (f32); samples past B and the zero rows are 0
  for (int i = tid; i < MP * C; i += nt) {
    const int c = i % C, m = i / C;
    float v = 0.f;
    if (m < M) {
      const int b = b0 + m / S, s = m % S;
      if (b < B) v = to_f32(x[b * xs_b + (s / W) * xs_h + (s % W) * xs_w + c]);
    }
    act0[c * MP + m] = v;
    act1[c * MP + m] = 0.f;
  }

  const int tm = tid % Mg, tn = tid / Mg;
  const bool active = tn < Cg;  // the rounding-up threads only stage
  int rs[TM], rh[TM], rw[TM];   // first pixel of the row's sample, h, w
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = tm * TM + i;
    rs[i] = m < M ? (m / S) * S : -1;
    rh[i] = (m % S) / W;
    rw[i] = (m % S) % W;
  }
  // this thread's four-wide slots of a weight chunk: row fr, column fc
  int fr[PV], fc[PV];
#pragma unroll
  for (int e = 0; e < PV; ++e) {
    const int v = tid + e * nt;
    fr[e] = v / (CP / 4);
    fc[e] = (v % (CP / 4)) * 4;
  }

  const int nc = (C + CK - 1) / CK;  // chunks per tap
  const int per_step = taps.n * nc;
  const int total = n * per_step;
  Raw4<T> pre[PV];
  auto fetch = [&](int q) {  // chunk q of the whole chain into registers
    const int step = q / per_step, rem = q % per_step;
    const int c0 = (rem % nc) * CK;
    const T* base = ws + ((size_t)step * kk + taps.wi[rem / nc]) * C * C;
#pragma unroll
    for (int e = 0; e < PV; ++e) {
      const int c = c0 + fr[e];
      const bool ok = fr[e] < CK && c < C;
      pre[e] = load_raw4(base + (size_t)c * C + fc[e], ok ? C - fc[e] : 0,
                         wvec);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float* cur = act0;
  float* nxt = act1;
  int src[TM];
  fetch(0);
  for (int q = 0; q < total; ++q) {
    const int rem = q % per_step;
    const int t = rem / nc, c0 = (rem % nc) * CK;
    __syncthreads();  // the chunk before is consumed, the last epilogue done
#pragma unroll
    for (int e = 0; e < PV; ++e)
      if (fr[e] < CK)
        *reinterpret_cast<float4*>(w_s + fr[e] * CP + fc[e]) = pre[e].f32();
    __syncthreads();
    if (q + 1 < total) fetch(q + 1);  // in flight while this chunk computes
    if (active) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int hh = rh[i] + taps.dy[t], ww = rw[i] + taps.dx[t];
        src[i] = (rs[i] >= 0 && hh >= 0 && hh < H && ww >= 0 && ww < W)
                     ? rs[i] + hh * W + ww
                     : M;
      }
      const int ck = min(CK, C - c0);
      const float* wrow = w_s + tn * TN;
      const float* arow = cur + c0 * MP;
#pragma unroll 4
      for (int r = 0; r < ck; ++r) {
        const float4 wv = *reinterpret_cast<const float4*>(wrow + r * CP);
        const float wj[TN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = arow[r * MP + src[i]];
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, wj[j], acc[i][j]);
        }
      }
    }
    if (rem == per_step - 1) {  // the step's last chunk: epilogue
      const int step = q / per_step;
      if (active) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int co = tn * TN + j;
          if (co >= C) continue;
          const float bias = bias_at(bs, bs_bf16, step * C + co);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int m = tm * TM + i;
            if (m < M) nxt[co * MP + m] = round_to(elu(acc[i][j] + bias), x);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  __syncthreads();
  for (int i = tid; i < M * C; i += nt) {
    const int c = i % C, m = i / C;
    const int b = b0 + m / S, s = m % S;
    if (b < B)
      store(out + b * os_b + (s / W) * os_h + (s % W) * os_w + c,
            cur[c * MP + m]);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core route
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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

// Warps: MT = ceil(M / 16) pixel tiles x ceil(C / 32) channel groups; each
// warp owns 16 pixels x 32 channels (four n8 tiles). Shared memory: two
// activation buffers of (Mpad + 1) rows and kStages (C, C) weight
// buffers, all bf16 with rows of C + 8 (an odd number of 16-byte units, so
// the eight rows of an ldmatrix phase fall in distinct banks), then the
// kStages full and kStages empty mbarriers of the weight ring. Launched in
// clusters of CL blocks (C % CL == 0); a block of a padded grid that owns
// no sample computes on zeros, stores nothing, and fetches and releases
// its share of the weights as the others do.
__global__ void __launch_bounds__(1024)
    conv_chain_mma_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ ws,
                          const void* __restrict__ bs, int bs_bf16,
                          bf16* __restrict__ out, int n, int B, int H, int W,
                          int C, int kk, long long xs_b, long long xs_h,
                          long long xs_w, long long os_b, long long os_h,
                          long long os_w, Taps taps, int SB, int CL) {
  extern __shared__ uint4 smem_u4[];
  bf16* smem = reinterpret_cast<bf16*>(smem_u4);
  const int S = H * W, M = SB * S;
  const int Mpad = (M + 15) & ~15;  // row Mpad is the zero row
  const int AP = C + 8;             // row pitch, elements
  const int MT = Mpad / 16;
  const int C8 = C / 8;
  bf16* act0 = smem;
  bf16* act1 = act0 + (Mpad + 1) * AP;
  bf16* wbuf = act1 + (Mpad + 1) * AP;  // kStages slots, C * AP apart
  uint64_t* full = reinterpret_cast<uint64_t*>(wbuf + kStages * C * AP);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * SB;
  const int rank = sm90::cluster_rank();
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1);    // this block's arm; the bytes
      sm90::mbar_init(empty + s, CL);  // one arrival from each block
    }
    sm90::fence_barrier_init();
  }
  sm90::cluster_sync();  // no peer copies or arrives before the barriers exist

  const int total = n * taps.n;
  const int rows = C / CL;  // this rank's share of a tap's rows
  const uint16_t all = (uint16_t)((1u << CL) - 1u);
  // warp 0: this block's arm of tap q's full barrier, and this rank's rows
  // of tap q's (C, C) matrix into its ring slot of every block of the
  // cluster, once every block has released the slot's tap before
  auto issue = [&](int q) {
    if (warp != 0 || q >= total) return;
    const int slot = q % kStages;
    if (q >= kStages)
      sm90::mbar_wait_cluster(empty + slot, (q / kStages - 1) & 1);
    if (lane == 0) sm90::mbar_arrive_expect_tx(full + slot, C * C * 2);
    const bf16* src =
        ws + ((size_t)(q / taps.n) * kk + taps.wi[q % taps.n]) * C * C;
    bf16* dst = wbuf + slot * C * AP;
    for (int r = rank * rows + lane; r < (rank + 1) * rows; r += 32)
      sm90::bulk_load_multicast(dst + r * AP, src + (size_t)r * C, C * 2,
                                full + slot, all);
    __syncwarp();
  };
  for (int q = 0; q < kStages - 1; ++q) issue(q);  // while staging

  // stage the block's samples, eight channels per item; the rest is zero
  for (int i = tid; i < (Mpad + 1) * C8; i += nt) {
    const int m = i / C8, c = (i % C8) * 8;
    uint4 v = zero;
    if (m < M) {
      const int b = b0 + m / S, s = m % S;
      if (b < B)
        v = __ldg(reinterpret_cast<const uint4*>(
            x + b * xs_b + (s / W) * xs_h + (s % W) * xs_w + c));
    }
    *reinterpret_cast<uint4*>(act0 + m * AP + c) = v;
    *reinterpret_cast<uint4*>(act1 + m * AP + c) = zero;
  }

  const int mt = warp % MT, ng = warp / MT;
  // the pixel whose row this lane names in the A tile's ldmatrix
  const int am = mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int as = am < M ? (am / S) * S : -1;
  const int ah = (am % S) / W, aw = (am % S) % W;
  const int acol = 8 * (lane >> 4);
  // the k row and n offset this lane names in a B ldmatrix.trans
  const int bk = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int bn = 8 * (lane >> 4);

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  bf16* cur = act0;
  bf16* nxt = act1;
  __syncthreads();  // the samples are staged
  for (int q = 0; q < total; ++q) {
    const int t = q % taps.n;
    const bf16* wb = wbuf + (q % kStages) * C * AP;
    issue(q + kStages - 1);  // into the slot read out at q - 1
    sm90::mbar_wait(full + q % kStages, (q / kStages) & 1);  // tap q landed
    const int hh = ah + taps.dy[t], ww = aw + taps.dx[t];
    const int src = (as >= 0 && hh >= 0 && hh < H && ww >= 0 && ww < W)
                        ? as + hh * W + ww
                        : Mpad;
    const bf16* arow = cur + src * AP + acol;
    for (int k0 = 0; k0 < C; k0 += 16) {
      unsigned a[4];
      ldsm_x4(arow + k0, a);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int n0 = (ng * 4 + 2 * jp) * 8;  // C % 16 == 0: both or none
        if (n0 < C) {
          unsigned b[4];
          ldsm_x4_trans(wb + (k0 + bk) * AP + n0 + bn, b);
          mma_bf16(acc[2 * jp], a, b[0], b[1]);
          mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
        }
      }
    }
    if (t == taps.n - 1) {  // the step's last tap: epilogue into nxt
      const int step = q / taps.n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = (ng * 4 + j) * 8 + (lane & 3) * 2;
        if (col < C) {
          const float bv0 = bias_at(bs, bs_bf16, step * C + col);
          const float bv1 = bias_at(bs, bs_bf16, step * C + col + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = mt * 16 + (lane >> 2) + 8 * h;
            if (row < M)
              *reinterpret_cast<__nv_bfloat162*>(nxt + row * AP + col) =
                  __floats2bfloat162_rn(elu(acc[j][2 * h] + bv0),
                                        elu(acc[j][2 * h + 1] + bv1));
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      }
      bf16* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    __syncthreads();  // wb is read out, the epilogue written
    if (tid == 0)  // ... so this block releases the slot in every block
      for (int r = 0; r < CL; ++r)
        sm90::mbar_arrive_cluster(empty + q % kStages, r);
  }
  for (int i = tid; i < M * C8; i += nt) {
    const int m = i / C8, c = (i % C8) * 8;
    const int b = b0 + m / S, s = m % S;
    if (b < B)
      *reinterpret_cast<uint4*>(out + b * os_b + (s / W) * os_h +
                                (s % W) * os_w + c) =
          *reinterpret_cast<const uint4*>(cur + m * AP + c);
  }
  sm90::cluster_sync();  // no peer still arrives on this block's barriers
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// the launch of the tensor-core kernel in clusters of CL blocks
cudaLaunchConfig_t cluster_config(unsigned grid, int threads, int smem_bytes,
                                  cudaStream_t s, int CL,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CL;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// the number of CL-block clusters of the tensor-core kernel that the card
// can hold at once, with `threads` threads and `smem_bytes` a block
extern "C" int sbc_conv_chain_max_clusters(int threads, int smem_bytes,
                                           int CL, int* out) {
  cudaError_t e = allow_smem(conv_chain_mma_kernel, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(CL, threads, smem_bytes, nullptr, CL, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(conv_chain_mma_kernel), &cfg);
}

// `grid` blocks of SB samples; route 1: the bf16 tensor-core kernel, in
// clusters of CL blocks (grid a multiple of CL); route 0: the FMA kernel
// (CL unused). A cluster launch the card refuses returns its error.
extern "C" int sbc_conv_chain(const void* x, const void* ws, const void* bs,
                              void* out, int n, int B, int H, int W, int C,
                              int k, long long xs_b, long long xs_h,
                              long long xs_w, long long os_b, long long os_h,
                              long long os_w, int ntaps, const int* dy,
                              const int* dx, const int* wi, int route,
                              int grid, int SB, int CL, int CK, int threads,
                              int smem_bytes, int bf16_in, int bs_bf16,
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
  cudaError_t e;
  if (route == 1) {
    if (!bf16_in || C % 16 != 0 || CL < 1 || CL > 16 || C % CL != 0)
      return (int)cudaErrorInvalidValue;
    if ((e = allow_smem(conv_chain_mma_kernel, smem_bytes)) != cudaSuccess)
      return (int)e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(grid, threads, smem_bytes, s, CL, &attr);
    e = cudaLaunchKernelEx(&cfg, conv_chain_mma_kernel,
                           static_cast<const bf16*>(x),
                           static_cast<const bf16*>(ws), bs, bs_bf16,
                           static_cast<bf16*>(out), n, B, H, W, C, k * k, xs_b,
                           xs_h, xs_w, os_b, os_h, os_w, taps, SB, CL);
    const cudaError_t last = cudaGetLastError();  // cleared either way
    return (int)(e != cudaSuccess ? e : last);
  }
  // the FMA kernel's prefetch covers one chunk with PV four-wide loads
  const int cp = (C + TN - 1) / TN * TN;
  if (CK < 1 || CK * cp > 4 * PV * threads) return (int)cudaErrorInvalidValue;
  const size_t esize = bf16_in ? 2 : 4;
  const int wvec = C % 4 == 0 && reinterpret_cast<size_t>(ws) % (4 * esize) == 0;
  if (bf16_in) {
    if ((e = allow_smem(conv_chain_fma_kernel<bf16>, smem_bytes)) !=
        cudaSuccess)
      return (int)e;
    conv_chain_fma_kernel<bf16><<<grid, threads, smem_bytes, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ws), bs, bs_bf16,
        static_cast<bf16*>(out), n, B, H, W, C, k * k, xs_b, xs_h, xs_w, os_b,
        os_h, os_w, taps, SB, CK, wvec);
  } else {
    if ((e = allow_smem(conv_chain_fma_kernel<float>, smem_bytes)) !=
        cudaSuccess)
      return (int)e;
    conv_chain_fma_kernel<float><<<grid, threads, smem_bytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(ws), bs,
        bs_bf16, static_cast<float*>(out), n, B, H, W, C, k * k, xs_b, xs_h,
        xs_w, os_b, os_h, os_w, taps, SB, CK, wvec);
  }
  return (int)cudaGetLastError();
}
