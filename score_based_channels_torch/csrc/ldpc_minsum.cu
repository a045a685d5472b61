// One normalized min-sum BP iteration of the LDPC decoder, dense masked
// messages in and out.
//
// Replaces the JAX package's kernels/ldpc_minsum.py::bp_iteration_pallas
// (body _bp_iter_kernel): variable totals llr + sum_i c2v, extrinsic
// messages c_in = total - c2v, per check row min1 / first-occurrence argmin
// / min2 of |c_in| and the parity of the negative c_in, and
// out = row_sign * sign(c_in) * (argmin ? min2 : min1) * normalize on live
// entries, 0 elsewhere.
//
// Layouts: c2v and out are (B, m, n) f32, llr (B, n) f32. The mask comes as
// edge tables built on the host from its contents, packed in one int32
// array (kernels/ldpc_minsum.py::edge_tables): CSR row_ptr (m+1) / row_cols
// (E), columns ascending within a row, then CSC col_ptr (n+1) / col_edge
// (E), the edge ids of each column with rows ascending, padded to 16
// bytes. Entries off the mask are never read (the JAX kernel re-masks
// them, so finite values there do not matter).
//
// Bound on an H100: bytes, the dense output written once (m*n*4 bytes a
// packet, 0.84 MB for the 802.11n (648, 324) code) and the live messages,
// llr and tables read once: 215 MB per iteration at B=256, 0.0651 ms at
// 3.35 TB/s. The TPU kernel streams the dense input as well, twice the
// bytes.
//
// Design: each live message is read from device memory once and every
// output byte written once, and the dense stores of one band run while the
// next band is built. One block per packet (design (a)): at the link's 256
// packets that is two blocks on each SM, all resident. A thread-block
// cluster that splits a packet's rows and columns (design (b), totals
// exchanged through distributed shared memory) was measured slower at 100
// and at 256 packets and is not kept: its extra cluster barriers and
// remote loads buy nothing the batch does not already give.
// (1) One bulk copy brings the packed tables into shared memory. (2) Each
// thread gathers the live messages of its check rows (a row's loads in
// flight together) into shared memory. (3) Thread j sums column j's
// messages in ascending row order, plus llr. (4) The output is built in
// bands of R consecutive check rows, a contiguous range of the packet's
// output, in two shared-memory buffers: a segment of lanes (a power of two
// at least the row's degree: 8 for this code, so a warp takes 4 rows at
// once) zeroes its row, takes the row's extrinsic messages one per lane,
// reduces min1 / argmin / min2 / parity with shuffles and writes the live
// values at their columns; then the band leaves by one bulk store
// (cp.async.bulk.global.shared::cta after fence.proxy.async) while the
// block builds the next band in the other buffer. No separate zero pass
// and no second write of a live entry remain. What stays between this and
// the bound: the bands' stores run at the card's write rate (that of
// Tensor.zero_ on the same output), but no packet can store a band before
// all its messages are in, so the scattered gathers of (2), one 32-byte
// sector for each 4-byte message, run with the memory otherwise idle.
// Every add, subtract and multiply is an explicit round-to-nearest
// intrinsic, so nvcc contracts nothing into an FMA; min1 is the least
// (value, position) pair, so ties go to the first position as with a
// strict <; the plain PyTorch version adds in the same order and pads rows
// to the longest with 1e9, so the two match bit for bit. A row length not
// a multiple of 4 floats is copied out by element stores; a bulk copy the
// pointers cannot take is an error.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSmem = 232448;
constexpr int kLoadBatch = 8;  // a row's loads in flight together
constexpr float kBig = 1e9f;   // the JAX body's |message| off the mask

// Shared memory (the same sums as kernels/ldpc_minsum.py::smem_bytes): two
// band buffers of R rows, the packed tables, the packet's live messages,
// the totals, the mbarrier.
struct Layout {
  int nt;  // packed table entries
  size_t band, tables, msgs, totals, bar, bytes;
  __host__ __device__ Layout(int m, int n, int E, int R) {
    band = ((size_t)R * n * 4 + 15) / 16 * 16;
    nt = (m + 1 + E + n + 1 + E + 3) / 4 * 4;
    tables = 2 * band;
    msgs = tables + (size_t)nt * 4;
    totals = msgs + ((size_t)E * 4 + 15) / 16 * 16;
    bar = totals + ((size_t)n * 4 + 15) / 16 * 16;
    bytes = bar + 16;
  }
};

// the two least |c_in| of a set of positions and the first position of
// the least: (m1, i) is the least (value, position) pair
struct Min2 {
  float m1, m2;
  int i;
};
__device__ __forceinline__ void take(Min2& a, float n1, int j1, float n2) {
  if (n1 < a.m1 || (n1 == a.m1 && j1 < a.i)) {
    a.m2 = fminf(a.m1, n2);
    a.m1 = n1;
    a.i = j1;
  } else {
    a.m2 = fminf(a.m2, n1);
  }
}

// grid: one block per packet; seg lanes per check row, bands of R rows
__global__ void __launch_bounds__(kThreads)
    ldpc_minsum_kernel(const float* __restrict__ c2v,
                       const float* __restrict__ llr,
                       float* __restrict__ out,
                       const int* __restrict__ packed, int m, int n, int E,
                       int dr, float normalize, int seg, int R, int bulk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(m, n, E, R);
  float* bufs = reinterpret_cast<float*>(smem);
  int* tab = reinterpret_cast<int*>(smem + L.tables);
  const int* row_ptr = tab;
  const int* row_cols = row_ptr + m + 1;
  const int* col_ptr = row_cols + E;
  const int* col_edge = col_ptr + n + 1;
  float* val = reinterpret_cast<float*>(smem + L.msgs);
  float* total = reinterpret_cast<float*>(smem + L.totals);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int tid = threadIdx.x;
  const size_t slab = (size_t)m * n;
  const float* msg = c2v + blockIdx.x * slab;
  float* o = out + blockIdx.x * slab;
  const float* l = llr + (size_t)blockIdx.x * n;

  // (1) the edge tables, one bulk copy
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(bar, L.nt * 4);
    sm90::bulk_load(tab, packed, L.nt * 4, bar);
  }
  sm90::mbar_wait(bar, 0);

  // (2) the packet's live messages, read once, a row's loads together
  for (int i = tid; i < m; i += blockDim.x) {
    const int k1 = row_ptr[i + 1];
    const float* mrow = msg + (size_t)i * n;
    for (int k = row_ptr[i]; k < k1; k += kLoadBatch) {
      float v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        v[u] = k + u < k1 ? __ldg(mrow + row_cols[k + u]) : 0.f;
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        if (k + u < k1) val[k + u] = v[u];
    }
  }
  __syncthreads();

  // (3) variable totals, each column summed in ascending row order
  for (int j = tid; j < n; j += blockDim.x) {
    float s = 0.f;
    for (int k = col_ptr[j]; k < col_ptr[j + 1]; ++k)
      s = __fadd_rn(s, val[col_edge[k]]);
    total[j] = __fadd_rn(l[j], s);
  }
  __syncthreads();

  // (4) bands of R rows; segment `sub` of a warp takes one row at a time
  const int lane = tid % 32, warp = tid / 32, nwarps = blockDim.x / 32;
  const int rpw = 32 / seg, q = lane % seg, sub = lane / seg;
  const size_t band_floats = L.band / 4;
  const int nbands = (m + R - 1) / R;
  for (int band = 0; band < nbands; ++band) {
    float* buf = bufs + (band & 1) * band_floats;
    const int r0 = band * R, r1 = min(r0 + R, m);
    // the store of band - 2 has read this buffer
    if (bulk && tid == 0 && band >= 2) sm90::bulk_wait_read<1>();
    __syncthreads();
    for (int first = r0 + warp * rpw; first < r1; first += nwarps * rpw) {
      const int i = first + sub;
      const bool live = i < r1;
      float* orow = buf + (size_t)(i - r0) * n;
      if (live) {
        if ((n & 3) == 0) {
          float4* o4 = reinterpret_cast<float4*>(orow);
          for (int c = q; c < n / 4; c += seg)
            o4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          for (int c = q; c < n; c += seg) orow[c] = 0.f;
        }
      }
      const int k0 = live ? row_ptr[i] : 0;
      const int deg = live ? row_ptr[i + 1] - k0 : 0;
      // positions q, q + seg, ... of the row padded to dr with kBig
      Min2 a = {CUDART_INF_F, CUDART_INF_F, INT_MAX};
      int neg = 0;
      for (int p = q; live && p < dr; p += seg) {
        float v = kBig;
        if (p < deg) {
          const float c = __fsub_rn(total[row_cols[k0 + p]], val[k0 + p]);
          v = fabsf(c);
          neg += c < 0.f;
        }
        take(a, v, p, CUDART_INF_F);
      }
      for (int off = seg / 2; off > 0; off >>= 1) {
        const float n1 = __shfl_xor_sync(0xffffffffu, a.m1, off);
        const float n2 = __shfl_xor_sync(0xffffffffu, a.m2, off);
        const int j1 = __shfl_xor_sync(0xffffffffu, a.i, off);
        neg += __shfl_xor_sync(0xffffffffu, neg, off);
        take(a, n1, j1, n2);
      }
      // min2 of a row of one position is the padding's kBig
      const float mag1 = __fmul_rn(a.m1, normalize);
      const float mag2 = __fmul_rn(fminf(a.m2, kBig), normalize);
      const bool odd = neg & 1;
      __syncwarp();  // the row's zeros land before its values
      for (int p = q; p < deg; p += seg) {
        const int j = row_cols[k0 + p];
        const float c = __fsub_rn(total[j], val[k0 + p]);
        const float mag = p == a.i ? mag2 : mag1;
        orow[j] = odd != (c < 0.f) ? -mag : mag;
      }
    }
    if (bulk) {
      sm90::fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        sm90::bulk_store(o + (size_t)r0 * n, buf, (uint32_t)(r1 - r0) * n * 4);
        sm90::bulk_commit();
      }
    } else {
      __syncthreads();
      for (size_t e = tid; e < (size_t)(r1 - r0) * n; e += blockDim.x)
        o[(size_t)r0 * n + e] = buf[e];
    }
  }
  if (bulk && tid == 0) sm90::bulk_wait_read<0>();
}

}  // namespace

// The launch of kernels/ldpc_minsum.py::plan: B blocks of kThreads, seg
// lanes per row, bands of R rows, element (0) or bulk (1) stores of a
// band, smem bytes.
extern "C" int sbc_ldpc_minsum(const void* c2v, const void* llr, void* out,
                               const void* packed, int B, int m, int n, int E,
                               int dr, float normalize, int seg, int R,
                               int bulk, int smem, void* stream) {
  if (B < 1 || m < 1 || n < 1 || E < 1 || dr < 1 || R < 1 || R > m ||
      (bulk != 0 && bulk != 1) ||
      (seg != 1 && seg != 2 && seg != 4 && seg != 8 && seg != 16 &&
       seg != 32))
    return (int)cudaErrorInvalidValue;
  const Layout L(m, n, E, R);
  if ((size_t)smem < L.bytes || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // the tables always come by one bulk copy, the bands by bulk stores
  // when the plan says so: 16-byte aligned, or an error (never a slower
  // form)
  if (bulk && n % 4 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      (bulk && reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  static bool attributes_set = false;
  if (!attributes_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ldpc_minsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ldpc_minsum_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    attributes_set = true;
  }
  ldpc_minsum_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c2v), static_cast<const float*>(llr),
      static_cast<float*>(out), static_cast<const int*>(packed), m, n, E, dr,
      normalize, seg, R, bulk);
  return (int)cudaGetLastError();
}
