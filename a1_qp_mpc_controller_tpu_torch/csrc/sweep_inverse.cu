// Batched symmetric-sweep inverse of SPD matrices, batch-leading, float32.
//
// Replaces the TPU kernel a1_qp_mpc_controller_tpu/ops/pallas_retired.py
// :489 batched_inverse_spd (body _sweep_inverse_kernel, :457). Sweeping
// every pivot of an SPD matrix gives -A^-1 in one array, negated at the
// end. Pivot k, with d = w[k, k] and r = row k (read as the column too):
//   w[i, j] - r[i] * (r[j] * (1/d))   off row k and column k,
//   r[j] * (1/d) on row k and r[i] * (1/d) on column k, -1/d at (k, k).
// This is the arithmetic of the batch-last sweep kernel with sym_col
// (csrc/inverse_t.cu), so the two agree bit for bit. The TPU version pads
// n to 128 lanes with identity pivots; those leave the n x n block as it
// is (each subtracts 0 * 0 from it), so the kernel runs the n pivots only.
//
// Bound on an H100 SXM: 2n^3 operations a matrix (~3.5 GFLOP at n = 120,
// B = 1024: ~0.053 ms at 67 TFLOP/s) against 2 x 59 MB read and written
// once (~0.035 ms), so operations bound it.
//
// Design: the batch-last sweep streams its whole (n, n, B) array through
// device memory every pivot (14 GB a call at B = 1024). Here one block
// holds one matrix in dynamic shared memory (n^2 + 2n floats: 58.6 KB at
// n = 120, three blocks an SM), read and written once. Each pivot stages
// the raw and the scaled pivot row, then a warp a row updates the array,
// lanes along the columns; two barriers a pivot. __fmul_rn / __fsub_rn and
// an IEEE 1.0f / d keep the rounding of the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads, 3)
sweep_inverse_kernel(const float* __restrict__ m_in, float* __restrict__ out,
                     int n) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* w = smem;           // n*n working array
  float* r = w + nn;         // n   pivot row, raw (the column too)
  float* rd = r + n;         // n   pivot row * (1/d)

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
      const float rk = w[k * n + j];
      r[j] = rk;
      rd[j] = __fmul_rn(rk, inv_d);
    }
    __syncthreads();
    const bool last = k == n - 1;
    for (int i = warp; i < n; i += nwarps) {
      float* row = w + i * n;
      const float ri = r[i];
      for (int j = lane; j < n; j += 32) {
        float v;
        if (i == k) {
          v = (j == k) ? -inv_d : rd[j];
        } else if (j == k) {
          v = rd[i];
        } else {
          v = __fsub_rn(row[j], __fmul_rn(ri, rd[j]));
        }
        row[j] = last ? -v : v;
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) dst[idx] = w[idx];
}

}  // namespace

// m, out: (batch, n, n) contiguous float32 on the device. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int sweep_inverse_launch(const float* m, float* out, int batch,
                                    int n, void* stream) {
  const size_t smem = static_cast<size_t>(n * n + 2 * n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  sweep_inverse_kernel<<<batch, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(m, out, n);
  return static_cast<int>(cudaGetLastError());
}
