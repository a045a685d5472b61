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
// edge tables built on the host from its contents: CSR row_ptr (m+1) /
// row_cols (E), columns ascending within a row, and CSC col_ptr (n+1) /
// col_rows (E), rows ascending within a column. Entries off the mask are
// never read (the JAX kernel re-masks them, so finite values there do not
// matter).
//
// Bound on an H100: bytes. The dense output is written once (m*n*4 bytes a
// packet, 0.84 MB for the 802.11n (648, 324) code); the live messages, llr
// and the tables are read once, about 1% more: 85.2 MB per iteration at
// B=100, 0.0254 ms at 3.35 TB/s. The TPU kernel streams the dense input
// as well, twice the bytes. Design: one block per packet. (1) The block
// zeroes its output slab with 16-byte stores. (2) Thread j sums column j's
// live messages in ascending row order into shared memory and adds llr.
// (3) Thread i walks check row i's live columns in ascending order twice:
// once for min1 / min2 (strict <, so the first occurrence is the argmin)
// and the negative count, once to write the outputs; the second pass reads
// again from L1. Every add, subtract and multiply is an explicit
// round-to-nearest intrinsic, so nvcc contracts nothing into an FMA and the
// plain PyTorch version, which adds in the same order, matches bit for bit.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr float kBig = 1e9f;  // the JAX body's |message| off the mask

__global__ void __launch_bounds__(kThreads)
    ldpc_minsum_kernel(const float* __restrict__ c2v,
                       const float* __restrict__ llr,
                       float* __restrict__ out,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ row_cols,
                       const int* __restrict__ col_ptr,
                       const int* __restrict__ col_rows, int m, int n,
                       float normalize) {
  extern __shared__ float total[];  // (n,) variable totals
  const size_t slab = (size_t)m * n;
  const float* msg = c2v + blockIdx.x * slab;
  float* o = out + blockIdx.x * slab;
  const float* l = llr + (size_t)blockIdx.x * n;

  // (1) zero the slab; live entries are written after the barrier below
  if ((slab & 3) == 0) {
    float4* o4 = reinterpret_cast<float4*>(o);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (size_t i = threadIdx.x; i < slab / 4; i += blockDim.x) o4[i] = z;
  } else {
    for (size_t i = threadIdx.x; i < slab; i += blockDim.x) o[i] = 0.f;
  }

  // (2) variable totals, each column summed in ascending row order
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float s = 0.f;
    for (int k = col_ptr[j]; k < col_ptr[j + 1]; ++k)
      s = __fadd_rn(s, msg[(size_t)col_rows[k] * n + j]);
    total[j] = __fadd_rn(l[j], s);
  }
  __syncthreads();

  // (3) one thread per check row
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int k0 = row_ptr[i], k1 = row_ptr[i + 1];
    const float* mrow = msg + (size_t)i * n;
    float min1 = kBig, min2 = kBig;
    int amin = -1, neg = 0;
    for (int k = k0; k < k1; ++k) {
      const int j = row_cols[k];
      const float c = __fsub_rn(total[j], mrow[j]);
      const float a = fabsf(c);
      neg += c < 0.f;
      if (a < min1) {
        min2 = min1;
        min1 = a;
        amin = k;
      } else if (a < min2) {
        min2 = a;
      }
    }
    const float mag1 = __fmul_rn(min1, normalize);
    const float mag2 = __fmul_rn(min2, normalize);
    const bool odd = neg & 1;
    float* orow = o + (size_t)i * n;
    for (int k = k0; k < k1; ++k) {
      const int j = row_cols[k];
      const float c = __fsub_rn(total[j], mrow[j]);
      const float mag = k == amin ? mag2 : mag1;
      orow[j] = odd != (c < 0.f) ? -mag : mag;
    }
  }
}

}  // namespace

extern "C" int sbc_ldpc_minsum(const void* c2v, const void* llr, void* out,
                               const void* row_ptr, const void* row_cols,
                               const void* col_ptr, const void* col_rows,
                               int B, int m, int n, float normalize,
                               void* stream) {
  const size_t smem = (size_t)n * sizeof(float);
  if (B < 1 || m < 1 || n < 1 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  ldpc_minsum_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c2v), static_cast<const float*>(llr),
      static_cast<float*>(out), static_cast<const int*>(row_ptr),
      static_cast<const int*>(row_cols), static_cast<const int*>(col_ptr),
      static_cast<const int*>(col_rows), m, n, normalize);
  return (int)cudaGetLastError();
}
