// Batched pivot-free Gauss-Jordan inverse of SPD KKT matrices, float32.
//
// Replaces the TPU kernel a1_qp_mpc_controller_tpu/ops/pallas_kernels.py
// :96 batched_inverse (body _gj_inverse_kernel, :41): the same lock-step
// pivot sequence, including the "diag - 1" elimination factor on the
// pivot row, so that the rank-1 update scales the pivot row in place
// (r - (diag - 1) r / diag = r / diag) and both versions round alike.
//
// With kSelectRow the same kernel replaces the retired
// a1_qp_mpc_controller_tpu/ops/pallas_retired.py:213
// batched_inverse_combined (body _gj_combined_kernel, :171, Gauss-Jordan
// on [M | I]): its only arithmetic difference is the pivot row, written
// as r * (1/d) by a select instead of r - (diag - 1) r / diag. K1's own
// instantiation (kSelectRow false) is the code above, unchanged.
//
// Bound on an H100 SXM: per matrix 120 pivots x 2 rank-1 updates of
// 120^2 ~ 6.9 MFLOP against 2 x 57.6 KB of device-memory traffic, so the
// work is bound by operations (float32 outside the tensor cores,
// 67 TFLOP/s) and, below that, by how fast one SM can stream its matrix
// through shared memory once per pivot: every pivot reads and writes
// both n x n arrays.
//
// Design: one thread block per matrix. M and its inverse live in dynamic
// shared memory (2 x 120 x 120 x 4 B = 115 KB), loaded once and written
// once, so device memory sees the minimum traffic. Each pivot stages the
// scaled pivot rows and the factor column in shared memory, then every
// thread updates its strided share of both arrays; two barriers per
// pivot; one warp per row in the update. No padding: n is a runtime
// argument. The products and
// differences are written with __fmul_rn / __fsub_rn so that no fused
// multiply-add changes the rounding against the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

template <bool kSelectRow>
__global__ void __launch_bounds__(kThreads)
gj_inverse_kernel(const float* __restrict__ m_in, float* __restrict__ out,
                  int n) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* sm = smem;          // n*n working copy of M
  float* si = sm + nn;       // n*n inverse, starts as I
  float* rowm = si + nn;     // n   pivot row of M, scaled by 1/diag
  float* rowi = rowm + n;    // n   pivot row of the inverse, scaled
  float* fac = rowi + n;     // n   elimination factors (pivot column)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const float* src = m_in + static_cast<size_t>(blockIdx.x) * nn;
  float* dst = out + static_cast<size_t>(blockIdx.x) * nn;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    sm[idx] = src[idx];
    si[idx] = (idx / n == idx % n) ? 1.0f : 0.0f;
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float diag = sm[k * n + k];
    const float inv_d = 1.0f / diag;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      rowm[j] = __fmul_rn(sm[k * n + j], inv_d);
      rowi[j] = __fmul_rn(si[k * n + j], inv_d);
      fac[j] = (j == k) ? __fsub_rn(diag, 1.0f) : sm[j * n + k];
    }
    __syncthreads();
    // one warp per row, lanes along the columns: fac[i] is a broadcast,
    // rowm/rowi and the row itself are read without bank conflicts
    for (int i = warp; i < n; i += nwarps) {
      const float f = fac[i];
      float* rm = sm + i * n;
      float* ri = si + i * n;
      if (kSelectRow && i == k) {
        for (int j = lane; j < n; j += 32) {
          rm[j] = rowm[j];
          ri[j] = rowi[j];
        }
        continue;
      }
      for (int j = lane; j < n; j += 32) {
        rm[j] = __fsub_rn(rm[j], __fmul_rn(f, rowm[j]));
        ri[j] = __fsub_rn(ri[j], __fmul_rn(f, rowi[j]));
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    dst[idx] = si[idx];
  }
}

}  // namespace

extern "C" size_t gj_inverse_smem_bytes(int n) {
  return static_cast<size_t>(2 * n * n + 3 * n) * sizeof(float);
}

namespace {

template <bool kSelectRow>
int launch(const float* m, float* out, int batch, int n, void* stream) {
  const size_t smem = gj_inverse_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_kernel<kSelectRow>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  gj_inverse_kernel<kSelectRow><<<batch, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      m, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, out: (batch, n, n) contiguous float32 on the device. Returns the
// CUDA error code of the launch (0 on success). K1:
extern "C" int gj_inverse_launch(const float* m, float* out, int batch,
                                 int n, void* stream) {
  return launch<false>(m, out, batch, n, stream);
}

// K6c, the pivot row written by a select:
extern "C" int gj_inverse_combined_launch(const float* m, float* out,
                                          int batch, int n, void* stream) {
  return launch<true>(m, out, batch, n, stream);
}
