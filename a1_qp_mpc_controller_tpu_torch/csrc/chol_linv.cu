// Batched L^-1 of SPD panels, A = L L' (p <= 128), float32.
//
// Replaces the TPU kernel a1_qp_mpc_controller_tpu/ops/pallas_kernels.py
// :212 batched_chol_linv (body _chol_linv_kernel, :158), the panel step
// of the blocked Cholesky inverse (ops/linalg.spd_cholesky_inverse_hybrid):
// p outer-product Cholesky steps on the trailing block, L' built row by
// row, then forward substitution for M = L^-1 row by row. The TPU version
// pads p to a multiple of 8 with an identity tail, which leaves the
// top-left block as it is; this one takes the exact p.
//
// Bound on an H100 SXM: ~2p^3/3 operations a panel (a Cholesky and a
// triangular inverse, p^3/3 each) against 2 p^2 x 4 B of device-memory
// traffic. At the hybrid's p = 30 and B = 1024 that is ~18 MFLOP
// (~0.0003 ms at 67 TFLOP/s) against ~7.4 MB (~0.0022 ms at 3.35 TB/s),
// so bytes bound it. In practice each panel is a chain of 2p
// barrier-separated steps, so the card is filled by running many panels
// at once.
//
// Design: one 128-thread block per panel, A, L' and M in dynamic shared
// memory (3 p^2 x 4 B = 10.8 KB at p = 30: over a dozen panels resident
// on an SM), loaded once and written once. A Cholesky step writes row k
// of L' and updates only the live trailing block, one warp a row and one
// lane a column (column k and row k of A are read, never written, in step
// k). A substitution step has one thread per column j summing
// L[k, r] M[r, j] over r = 0..k-1 in order. Products, quotients, sums and
// the square root are __fmul_rn / __fdiv_rn / __fadd_rn / __fsub_rn /
// __fsqrt_rn, so no fused multiply-add changes the rounding against the
// plain PyTorch version, and the 1e-30 clamps let NaN through as
// torch.clamp does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ float clamp_tiny(float x) {
  return x < kTiny ? kTiny : x;    // NaN passes, as in torch.clamp
}

__global__ void __launch_bounds__(kThreads)
chol_linv_kernel(const float* __restrict__ a_in, float* __restrict__ out,
                 int p) {
  extern __shared__ float smem[];
  const int pp = p * p;
  float* sa = smem;          // p*p working copy of A
  float* lt = sa + pp;       // p*p L', row k = column k of L
  float* sm = lt + pp;       // p*p M = L^-1

  const int tid = threadIdx.x;
  const float* src = a_in + static_cast<size_t>(blockIdx.x) * pp;
  float* dst = out + static_cast<size_t>(blockIdx.x) * pp;
  for (int idx = tid; idx < pp; idx += kThreads) {
    sa[idx] = src[idx];
    lt[idx] = 0.0f;
    sm[idx] = 0.0f;
  }
  __syncthreads();

  const int lane = tid % 32;
  const int warp = tid / 32;
  for (int k = 0; k < p; ++k) {
    const float akk = clamp_tiny(sa[k * p + k]);
    const float sq = __fsqrt_rn(akk);
    for (int j = k + tid; j < p; j += kThreads) {
      lt[k * p + j] = (j == k) ? sq : __fdiv_rn(sa[k * p + j], sq);
    }
    for (int i = k + 1 + warp; i < p; i += kWarps) {
      const float c = sa[i * p + k];
      for (int j = k + 1 + lane; j < p; j += 32) {
        sa[i * p + j] = __fsub_rn(
            sa[i * p + j], __fdiv_rn(__fmul_rn(c, sa[k * p + j]), akk));
      }
    }
    __syncthreads();
  }

  for (int k = 0; k < p; ++k) {
    const float lkk = clamp_tiny(lt[k * p + k]);
    for (int j = tid; j < p; j += kThreads) {
      float acc = 0.0f;
      for (int r = 0; r < k; ++r) {
        acc = __fadd_rn(acc, __fmul_rn(lt[r * p + k], sm[r * p + j]));
      }
      sm[k * p + j] = __fdiv_rn(__fsub_rn(j == k ? 1.0f : 0.0f, acc), lkk);
    }
    __syncthreads();
  }

  for (int idx = tid; idx < pp; idx += kThreads) dst[idx] = sm[idx];
}

size_t smem_bytes(int p) {
  return static_cast<size_t>(3 * p * p) * sizeof(float);
}

}  // namespace

// a, out: (batch, p, p) contiguous float32 on the device, p <= 128.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int chol_linv_launch(const float* a, float* out, int batch, int p,
                                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chol_linv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(p)));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  chol_linv_kernel<<<batch, kThreads, smem_bytes(p),
                     static_cast<cudaStream_t>(stream)>>>(a, out, p);
  return static_cast<int>(cudaGetLastError());
}
