// Batched pivot-free Gauss-Jordan inverse of small SPD matrices
// (n <= 128), float32.
//
// Replaces the TPU kernel a1_qp_mpc_controller_tpu/ops/pallas_kernels.py
// :126 batched_inverse_small (body _gj_inverse_kernel, :41): the same
// lock-step pivot sequence as K1 (csrc/inverse_t.cu), with the
// "diag - 1" elimination factor on the pivot row, so that the rank-1
// update scales the pivot row in place and both versions round alike.
// The TPU version pads rows to 8 sublanes and columns to 128 lanes; this
// one takes the exact n.
//
// Bound on an H100 SXM: per matrix n pivots x 2 rank-1 updates of n^2,
// ~4n^3 operations against 2 n^2 x 4 B of device-memory traffic. At the
// reduced route's n = 66 and B = 1024 that is ~1.2 GFLOP (float32 outside
// the tensor cores, 67 TFLOP/s: ~0.018 ms) against ~36 MB (~0.011 ms),
// so operations bound it. In practice one matrix's pivot loop is a chain
// of n barrier-separated passes, so the card is filled only by running
// many matrices at once.
//
// Design: one thread block per matrix, M and its inverse in dynamic
// shared memory (2 x 66^2 x 4 B = 34.8 KB at n = 66), loaded once and
// written once. Unlike K1 (115 KB, one matrix per SM) the block is sized
// so that six matrices co-reside on an SM: 256 threads and at most 42
// registers a thread (__launch_bounds__(256, 6)), the shared-memory
// carveout set to its maximum. The rank-1 update walks the flat n x n
// array with a stride of the block size, every lane busy, the row and
// column of each element advanced without a division. Products and
// differences are __fmul_rn / __fsub_rn, so no fused multiply-add
// changes the rounding against the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocksPerSm = 6;

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
gj_inverse_small_kernel(const float* __restrict__ m_in,
                        float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* sm = smem;          // n*n working copy of M
  float* si = sm + nn;       // n*n inverse, starts as I
  float* rowm = si + nn;     // n   pivot row of M, scaled by 1/diag
  float* rowi = rowm + n;    // n   pivot row of the inverse, scaled
  float* fac = rowi + n;     // n   elimination factors (pivot column)

  const int tid = threadIdx.x;
  const int step = blockDim.x;
  const float* src = m_in + static_cast<size_t>(blockIdx.x) * nn;
  float* dst = out + static_cast<size_t>(blockIdx.x) * nn;
  for (int idx = tid; idx < nn; idx += step) {
    sm[idx] = src[idx];
    si[idx] = (idx / n == idx % n) ? 1.0f : 0.0f;
  }
  // (row, column) of this thread's first element, and how far one
  // stride of `step` elements moves them
  const int i0 = tid / n, j0 = tid % n;
  const int di = step / n, dj = step % n;
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float diag = sm[k * n + k];
    const float inv_d = 1.0f / diag;
    for (int j = tid; j < n; j += step) {
      rowm[j] = __fmul_rn(sm[k * n + j], inv_d);
      rowi[j] = __fmul_rn(si[k * n + j], inv_d);
      fac[j] = (j == k) ? __fsub_rn(diag, 1.0f) : sm[j * n + k];
    }
    __syncthreads();
    int i = i0, j = j0;
    for (int idx = tid; idx < nn; idx += step) {
      const float f = fac[i];
      sm[idx] = __fsub_rn(sm[idx], __fmul_rn(f, rowm[j]));
      si[idx] = __fsub_rn(si[idx], __fmul_rn(f, rowi[j]));
      i += di;
      j += dj;
      if (j >= n) {
        j -= n;
        ++i;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < nn; idx += step) dst[idx] = si[idx];
}

size_t smem_bytes(int n) {
  return static_cast<size_t>(2 * n * n + 3 * n) * sizeof(float);
}

cudaError_t set_attributes(int n) {
  cudaError_t err = cudaFuncSetAttribute(
      gj_inverse_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(n)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      gj_inverse_small_kernel,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Thread blocks (matrices) of size n that CUDA's occupancy calculator
// fits on one SM at once, or minus the CUDA error code.
extern "C" int gj_inverse_small_occupancy(int n) {
  cudaError_t err = set_attributes(n);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, gj_inverse_small_kernel, kThreads, smem_bytes(n));
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks;
}

// m, out: (batch, n, n) contiguous float32 on the device, n <= 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gj_inverse_small_launch(const float* m, float* out,
                                       int batch, int n, void* stream) {
  cudaError_t err = set_attributes(n);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  gj_inverse_small_kernel<<<batch, kThreads, smem_bytes(n),
                            static_cast<cudaStream_t>(stream)>>>(m, out, n);
  return static_cast<int>(cudaGetLastError());
}
