// Batched pivot-free Gauss-Jordan inverse in ONE working array, float32.
//
// Replaces the TPU kernel a1_qp_mpc_controller_tpu/ops/pallas_retired.py
// :144 batched_inverse_inplace (body _gj_inplace_kernel, :95). The inverse
// overwrites the matrix column by column: at pivot k only M's columns > k
// and the inverse's columns <= k are live, so one n x n array holds both.
// Pivot k, with d = w[k, k], r = row k and c = column k:
//   w[i, j] - c[i] * (r[j] * (1/d))   off row k and column k,
//   r[j] * (1/d) on row k, -c[i] * (1/d) on column k, 1/d at (k, k).
//
// Bound on an H100 SXM: the same 2n^2(n+1) operations a matrix as any
// Gauss-Jordan inverse (~3.6 GFLOP at n = 120, B = 1024: ~0.053 ms at
// 67 TFLOP/s outside the tensor cores) against 2 x 59 MB read and written
// once (~0.035 ms at 3.35 TB/s), so operations bound it. In practice one
// SM streams its matrix through shared memory once per pivot.
//
// Design: one thread block per matrix, the single working array in
// dynamic shared memory (n^2 + 2n floats: 58.6 KB at n = 120, so three
// blocks share an SM where the two-array kernel K1 fits one). Each pivot
// stages the scaled pivot row and the raw pivot column, then a warp a row
// updates the array, lanes along the columns; two barriers a pivot. The
// products and differences are __fmul_rn / __fsub_rn and 1.0f / d an IEEE
// division, so no fused multiply-add changes the rounding against the
// plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads, 3)
gj_inplace_kernel(const float* __restrict__ m_in, float* __restrict__ out,
                  int n) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* w = smem;           // n*n working array: M, then its inverse
  float* rd = w + nn;        // n   pivot row * (1/d), 1/d at k
  float* col = rd + n;       // n   pivot column, raw

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const float* src = m_in + static_cast<size_t>(blockIdx.x) * nn;
  float* dst = out + static_cast<size_t>(blockIdx.x) * nn;
  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) w[idx] = src[idx];
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float inv_d = 1.0f / w[k * n + k];
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      rd[j] = (j == k) ? inv_d : __fmul_rn(w[k * n + j], inv_d);
      col[j] = w[j * n + k];
    }
    __syncthreads();
    for (int i = warp; i < n; i += nwarps) {
      float* row = w + i * n;
      if (i == k) {
        for (int j = lane; j < n; j += 32) row[j] = rd[j];
        continue;
      }
      const float c = col[i];
      for (int j = lane; j < n; j += 32) {
        row[j] = (j == k) ? -__fmul_rn(c, inv_d)
                          : __fsub_rn(row[j], __fmul_rn(c, rd[j]));
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) dst[idx] = w[idx];
}

}  // namespace

// m, out: (batch, n, n) contiguous float32 on the device. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int gj_inplace_launch(const float* m, float* out, int batch,
                                 int n, void* stream) {
  const size_t smem = static_cast<size_t>(n * n + 2 * n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gj_inplace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  gj_inplace_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(m, out, n);
  return static_cast<int>(cudaGetLastError());
}
