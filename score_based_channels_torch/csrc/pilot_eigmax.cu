// The largest eigenvalue of each sample's pilot Gram P P^H: LDAMP's step
// size eig1.
//
// Replaces no Pallas kernel: the JAX package takes eig1 from eigvalsh on
// the host, where it makes the batch (data/dataset.py). Added so that
// LDAMP's training step can assemble its batch from the host's draws inside
// its CUDA graph: torch.linalg.eigvalsh on the card reads its solver's
// status on the host, which a capture cannot hold, and on the host it took
// most of the time the card waited for each batch.
//
// Layouts: P is (B, Nt, Np) complex in c2 (float2), contiguous; eig (B,)
// f32; sweeps (B,) int32, the sweeps each sample took.
//
// Bound on an H100: latency. At LDAMP's recipe (B = 128, Nt = 64, Np = 38)
// the kernel reads 2.5 MB (0.75 us at 3.35 TB/s) and does ~2 GFLOP (~30 us
// at 67 TFLOP/s f32), but a sample's sweeps run one after the other: rounds
// of a shuffle reduction, a rotation and a block barrier each.
//
// Design: one block per sample, P in shared memory (19.5 KB at 64 x 38),
// one-sided (Hestenes) Jacobi over the n = min(Nt, Np) columns of P (the
// rows when Np > Nt), each of length L = max(Nt, Np): a rotation of two
// columns makes them orthogonal, and once all are, the columns are the
// left singular vectors times the singular values, whose squares are the
// nonzero eigenvalues of P P^H. A sweep visits every pair once, in n - 1
// rounds (n for odd n) of disjoint pairs (the round-robin order), a
// half-warp a pair: at the recipe 10 warps, 37 rounds a sweep (a warp a
// pair took 0.222 ms against 0.168 at the recipe). A pair rotates
// when |p_i^H p_j|^2 exceeds tol^2 |p_i|^2 |p_j|^2 (tol = 8 sqrt(L)
// FLT_EPSILON, 7.6e-6 at L = 64); a sweep with no rotation ends the
// sample, else kMaxSweeps does (7-9 sweeps at Nt = 64 and Np 38 on the
// card). lambda_max is then read as the Rayleigh quotient of the Gram
// at the largest column u, |M^H u|^2 / |u|^2 over the columns M of P as
// loaded: in exact arithmetic it is the largest column's norm^2, and it
// leaves out the rounding that hundreds of rotations leave in the norms
// (1e-5 relative at Np = 64 in a float32 emulation; the quotient 1e-7).
// 128 samples are one wave of the 132 SMs. A lane holds its pair's
// elements in registers from the sums to the rotation (L <= 128, up to 8
// a lane). Every lane of a half-warp sums in the same butterfly, so a
// pair's lanes agree on its rotation bit for bit.

#include <cuda_runtime.h>
#include <float.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxSweeps = 30;
constexpr float kTolFactor = 8.f;  // tol = kTolFactor sqrt(L) FLT_EPSILON
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;
constexpr int kMaxLength = 128;    // L: 8 elements a lane

// xor butterflies: every lane ends with the same sum, of its warp or of
// its half-warp
__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
  for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Shared memory: the rotated columns and
// the columns as loaded, n x (L + 1) float2 each (a padded row, so the
// transposing load spreads over the banks), n column norms and a sum for
// each of 32 warps.
__host__ __device__ inline size_t smem_needed(int n, int L) {
  return 2 * (size_t)n * (L + 1) * sizeof(float2) +
         (size_t)(n + 32) * sizeof(float);
}

// A half-warp takes a pair, K (ceil(L / 16) rounded up to 2, 4 or 8)
// elements of each column a lane, held in registers from the pair's sums to
// its rotation; every half-warp runs the sums (on zeros when it has no live
// pair), so both halves of a warp meet at each shuffle.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
pilot_eigmax_kernel(const float2* __restrict__ P, float* __restrict__ eig,
                    int* __restrict__ sweeps_out, int Nt, int Np) {
  extern __shared__ float2 smem[];
  const bool by_cols = Np <= Nt;
  const int n = by_cols ? Np : Nt;  // vectors
  const int L = by_cols ? Nt : Np;  // their length
  const int ld = L + 1;
  float2* V = smem;                          // rotated
  float2* M = smem + (size_t)n * ld;         // as loaded
  float* norms = reinterpret_cast<float*>(M + (size_t)n * ld);
  float* warp_part = norms + n;
  const float2* Pb = P + (size_t)blockIdx.x * Nt * Np;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int p = tid >> 4, sub = tid & 15;  // the half-warp's pair, its lane

  for (int e = tid; e < Nt * Np; e += blockDim.x) {
    const int t = e / Np, j = e - t * Np;  // P[t, j]
    const float2 x = Pb[e];
    const int at = by_cols ? j * ld + t : t * ld + j;
    V[at] = x;
    M[at] = x;
  }
  __syncthreads();

  // round-robin: R + 1 players (one a dummy for an odd n), R rounds
  const int R = n - 1 + (n & 1), pairs = (R + 1) / 2;
  const float tol = kTolFactor * sqrtf((float)L) * FLT_EPSILON;
  const float tol2 = tol * tol;
  int sweep = 0, more = 1;
  while (more && sweep < kMaxSweeps) {
    ++sweep;
    int rotated = 0;
    for (int r = 0; r < R; ++r) {
      int a = r, b = R;
      if (p > 0) {
        a = r + p < R ? r + p : r + p - R;
        b = r - p >= 0 ? r - p : r - p + R;
      }
      const bool live = p < pairs && a < n && b < n;  // not the dummy
      float2* x = V + (size_t)(live ? a : 0) * ld;
      float2* y = V + (size_t)(live ? b : 0) * ld;
      float2 u[K], v[K];
      float al = 0.f, be = 0.f, gr = 0.f, gi = 0.f;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int k = sub + 16 * q;
        u[q] = live && k < L ? x[k] : make_float2(0.f, 0.f);
        v[q] = live && k < L ? y[k] : make_float2(0.f, 0.f);
        al = fmaf(u[q].x, u[q].x, fmaf(u[q].y, u[q].y, al));
        be = fmaf(v[q].x, v[q].x, fmaf(v[q].y, v[q].y, be));
        gr = fmaf(u[q].x, v[q].x, fmaf(u[q].y, v[q].y, gr));   // Re u^H v
        gi = fmaf(u[q].x, v[q].y, fmaf(-u[q].y, v[q].x, gi));  // Im u^H v
      }
      al = half_sum(al);
      be = half_sum(be);
      gr = half_sum(gr);
      gi = half_sum(gi);
      const float off2 = fmaf(gr, gr, gi * gi);
      if (live && off2 > tol2 * al * be) {
        rotated = 1;
        // the 2x2 Gram [[al, g], [conj g, be]], g = |g| e^{i phi}: the real
        // Jacobi rotation (c, s) of [[al, |g|], [|g|, be]] after the
        // phase. Approximate reciprocals and roots: a rotation a few ulp
        // from unitary moves the norms, not the quotient read at the end.
        const float inv_off = rsqrtf(off2);
        const float zeta = 0.5f * (be - al) * inv_off;
        const float az = fabsf(zeta);
        const float w = fmaf(az, az, 1.f);  // t = 1 / (|zeta| + sqrt(w))
        const float t = copysignf(
            az < 1e15f ? __fdividef(1.f, fmaf(w, rsqrtf(w), az))
                       : __fdividef(0.5f, az),
            zeta);
        const float c = rsqrtf(fmaf(t, t, 1.f));
        const float s = c * t;
        const float er = gr * inv_off, ei = gi * inv_off;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const int k = sub + 16 * q;
          // x' = c u - s e^{-i phi} v, y' = s e^{i phi} u + c v
          const float wr = fmaf(er, v[q].x, ei * v[q].y);
          const float wi = fmaf(er, v[q].y, -ei * v[q].x);
          const float zr = fmaf(er, u[q].x, -ei * u[q].y);
          const float zi = fmaf(er, u[q].y, ei * u[q].x);
          if (k < L) {
            x[k] = make_float2(fmaf(-s, wr, c * u[q].x),
                               fmaf(-s, wi, c * u[q].y));
            y[k] = make_float2(fmaf(s, zr, c * v[q].x),
                               fmaf(s, zi, c * v[q].y));
          }
        }
      }
      __syncthreads();
    }
    more = __syncthreads_or(rotated);
  }

  for (int v = warp; v < n; v += warps) {
    const float2* x = V + (size_t)v * ld;
    float s2 = 0.f;
    for (int k = lane; k < L; k += 32)
      s2 = fmaf(x[k].x, x[k].x, fmaf(x[k].y, x[k].y, s2));
    s2 = warp_sum(s2);
    if (lane == 0) norms[v] = s2;
  }
  __syncthreads();
  int top = 0;  // the largest column, the first of equals
  for (int v = 1; v < n; ++v)
    if (norms[v] > norms[top]) top = v;
  const float2* u = V + (size_t)top * ld;
  float part = 0.f;
  for (int j = warp; j < n; j += warps) {
    const float2* m = M + (size_t)j * ld;
    float dr = 0.f, di = 0.f;
    for (int k = lane; k < L; k += 32) {
      dr = fmaf(m[k].x, u[k].x, fmaf(m[k].y, u[k].y, dr));
      di = fmaf(m[k].x, u[k].y, fmaf(-m[k].y, u[k].x, di));
    }
    dr = warp_sum(dr);
    di = warp_sum(di);
    part = fmaf(dr, dr, fmaf(di, di, part));
  }
  if (lane == 0) warp_part[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float q = 0.f;
    for (int w = 0; w < warps; ++w) q += warp_part[w];
    eig[blockIdx.x] = norms[top] > 0.f ? q / norms[top] : 0.f;
    sweeps_out[blockIdx.x] = sweep;
  }
}

// The launch of Nt x Np pilots: a half-warp for each pair of a round, in
// whole warps, and the shared bytes; false when the kernel does not take
// them (the longer side past kMaxLength, or past a block's shared memory).
bool launch_shape(int Nt, int Np, int* threads, size_t* smem) {
  if (Nt < 1 || Np < 1) return false;
  const int n = Np <= Nt ? Np : Nt, L = Np <= Nt ? Nt : Np;
  const int pairs = (n + 1) / 2;
  *threads = 32 * ((pairs + 1) / 2);
  *smem = smem_needed(n, L);
  return L <= kMaxLength && *threads <= kMaxThreads && *smem <= kMaxSmem;
}

}  // namespace

extern "C" int sbc_pilot_eigmax_fits(int Nt, int Np) {
  int threads;
  size_t smem;
  return launch_shape(Nt, Np, &threads, &smem) ? 1 : 0;
}

extern "C" int sbc_pilot_eigmax_max_sweeps(void) { return kMaxSweeps; }

extern "C" int sbc_pilot_eigmax(const void* P, void* eig, void* sweeps, int B,
                                int Nt, int Np, void* stream) {
  int threads;
  size_t smem;
  if (B < 1 || !launch_shape(Nt, Np, &threads, &smem))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(P) % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  static bool attributes_set = false;
  if (!attributes_set) {
    const void* kernels[3] = {(const void*)pilot_eigmax_kernel<2>,
                              (const void*)pilot_eigmax_kernel<4>,
                              (const void*)pilot_eigmax_kernel<8>};
    cudaError_t e = cudaSuccess;
    for (int i = 0; i < 3 && e == cudaSuccess; ++i)
      e = cudaFuncSetAttribute(
          kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    attributes_set = true;
  }
  const int L = Np <= Nt ? Nt : Np;
  auto kernel = L <= 32 ? pilot_eigmax_kernel<2>
                : L <= 64 ? pilot_eigmax_kernel<4> : pilot_eigmax_kernel<8>;
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(P), static_cast<float*>(eig),
      static_cast<int*>(sweeps), Nt, Np);
  return (int)cudaGetLastError();
}
