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
// so bytes bound it. Each panel is a chain of 2p dependent steps, so the
// card is filled by running many panels at once.
//
// Two tiers, the split gj_rank.cu makes:
//
// - p <= 32, the register tier (chol_linv_reg_kernel<P>, P = 8, 16 or 32
//   the smallest that holds p): one warp a panel, kPanels panels a block,
//   no shared memory and no barrier. Lane j holds column j of the panel
//   in registers, loaded and stored row by row across the lanes
//   (coalesced), as a window w: at step k, w[t] is row k + t, and the
//   window moves up a row a step, so that the step loop runs at run time
//   on static register indices (unrolled over the steps the code was
//   ~300 KB and a quarter slower). Cholesky step k takes a_kk and the
//   column-k entries a_ik (i > k) from lane k by __shfl_sync, all of them
//   before its divisions, and a_kj from the lane's own w[0]; lanes j > k
//   update their a_ij, and every lane pushes L'[k][j] (0 for j < k) onto
//   its column of L' (lt, moved a place a step, and P - p places after
//   the last step so that lt[r] = L'[r][j]). Substitution step k has
//   lane k broadcast L'[r][k] (r < k) and L'[k][k], and lane j sums its
//   own M[r][j] over r = 0..k-1 in ascending order (M in registers).
//   Rows, columns and steps past p are guarded (lanes past p load zeros
//   and store nothing).
// - p > 32, the wide tier (chol_linv_kernel): one 128-thread block a
//   panel, A, L' and M in dynamic shared memory (3 p^2 x 4 B), loaded once
//   and written once. A Cholesky step writes row k of L' and updates only
//   the live trailing block, one warp a row and one lane a column (column
//   k and row k of A are read, never written, in step k). A substitution
//   step has one thread per column j summing L[k, r] M[r, j] over
//   r = 0..k-1 in order.
//
// The panel is not assumed symmetric (it comes from blocked trailing
// updates): row k and column k are read as they are, as the plain
// version reads them. Both tiers keep the plain PyTorch version's every
// operation and its order, so they are bit-equal to it: (a_ik a_kj) / a_kk
// by __fmul_rn then __fdiv_rn, then __fsub_rn; __fsqrt_rn; the sums from
// 0 by __fmul_rn / __fadd_rn; no fused multiply-add and no reciprocal;
// the 1e-30 clamps let NaN through as torch.clamp does. Lanes whose
// result a step discards divide zero, not their stale values.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRegMax = 32;        // the register tier's largest panel
constexpr int kPanels = 4;         // register tier: panels (warps) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-30f;

__device__ __forceinline__ float clamp_tiny(float x) {
  return x < kTiny ? kTiny : x;    // NaN passes, as in torch.clamp
}

// x / y as __fdiv_rn rounds it, for a clamped divisor (y >= 1e-30, +inf
// or NaN), where a zero x gives x itself (or y's NaN): the quotient IEEE
// division gives. The division's range check sends a zero dividend down
// its slow path, which the KKT's many exact zeros and the lanes whose
// quotient is discarded would take on most divisions, so a zero x
// divides 1 in its place (no branch: on the KKT's panels as fast as
// skipping the division, on dense ones 1.4x faster; PERF.md).
__device__ __forceinline__ float div_clamped(float x, float y) {
  const float q = __fdiv_rn(x == 0.0f ? 1.0f : x, y);
  return x == 0.0f ? (y == y ? x : y) : q;
}

template <int P>
__global__ void __launch_bounds__(32 * kPanels)
chol_linv_reg_kernel(const float* __restrict__ a_in, float* __restrict__ out,
                     int batch, int p) {
  const int lane = threadIdx.x % 32;
  const int panel = blockIdx.x * kPanels + threadIdx.x / 32;
  if (panel >= batch) return;      // the whole warp: no shuffle is left
  const int pp = p * p;
  const float* src = a_in + static_cast<size_t>(panel) * pp;
  float* dst = out + static_cast<size_t>(panel) * pp;
  const bool live = lane < p;

  float w[P];    // column `lane`, rows k.. of the working panel at step k
  float lt[P];   // column `lane` of L', pushed at the top a step
  float m[P];    // column `lane` of M
#pragma unroll
  for (int i = 0; i < P; ++i) {
    w[i] = (live && i < p) ? src[i * p + lane] : 0.0f;
    lt[i] = 0.0f;
    m[i] = 0.0f;
  }

  for (int k = 0; k < p; ++k) {
    const float akk = clamp_tiny(__shfl_sync(kFull, w[0], k));
    const float sq = __fsqrt_rn(akk);
    const float akj = w[0];
    float col[P];
#pragma unroll
    for (int t = 1; t < P; ++t) col[t] = __shfl_sync(kFull, w[t], k);
#pragma unroll
    for (int t = 1; t < P; ++t) {
      if (k + t >= p) break;
      const float num = lane > k ? __fmul_rn(col[t], akj) : 0.0f;
      const float upd = __fsub_rn(w[t], div_clamped(num, akk));
      w[t] = lane > k ? upd : w[t];
    }
    const float lkj = div_clamped(lane > k ? akj : 0.0f, sq);
#pragma unroll
    for (int t = 0; t + 1 < P; ++t) {
      lt[t] = lt[t + 1];
      w[t] = w[t + 1];
    }
    lt[P - 1] = lane == k ? sq : lkj;
    w[P - 1] = 0.0f;
  }
  for (int k = p; k < P; ++k) {      // row r of L' to lt[r]
#pragma unroll
    for (int t = 0; t + 1 < P; ++t) lt[t] = lt[t + 1];
    lt[P - 1] = 0.0f;
  }

#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (k >= p) break;
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < k; ++r) {
      acc = __fadd_rn(acc, __fmul_rn(__shfl_sync(kFull, lt[r], k), m[r]));
    }
    const float lkk = clamp_tiny(__shfl_sync(kFull, lt[k], k));
    m[k] = div_clamped(__fsub_rn(lane == k ? 1.0f : 0.0f, acc), lkk);
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < p) dst[i * p + lane] = m[i];
  }
}

using RegKernel = void (*)(const float*, float*, int, int);

RegKernel reg_kernel(int p) {
  return p <= 8 ? chol_linv_reg_kernel<8>
                : p <= 16 ? chol_linv_reg_kernel<16>
                          : chol_linv_reg_kernel<32>;
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
  if (p <= kRegMax) {
    if (batch == 0 || p == 0) return 0;
    reg_kernel(p)<<<(batch + kPanels - 1) / kPanels, 32 * kPanels, 0,
                    static_cast<cudaStream_t>(stream)>>>(a, out, batch, p);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      chol_linv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(p)));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  chol_linv_kernel<<<batch, kThreads, smem_bytes(p),
                     static_cast<cudaStream_t>(stream)>>>(a, out, p);
  return static_cast<int>(cudaGetLastError());
}

// The kernel that p selects (the register tier's instantiation for
// p <= 32, else the shared-memory kernel with its p's shared memory):
// blocks resident an SM by CUDA's occupancy calculator (or minus the CUDA
// error code); *regs and *local_bytes get its registers a thread and its
// local memory a thread (spills).
extern "C" int chol_linv_occupancy(int p, int* regs, int* local_bytes) {
  const bool reg = p <= kRegMax;
  cudaFuncAttributes attr;
  cudaError_t err = reg ? cudaFuncGetAttributes(&attr, reg_kernel(p))
                        : cudaFuncGetAttributes(&attr, chol_linv_kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  int blocks = 0;
  if (reg) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reg_kernel(p), 32 * kPanels, 0);
  } else {
    err = cudaFuncSetAttribute(chol_linv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes(p)));
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, chol_linv_kernel, kThreads, smem_bytes(p));
    }
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks;
}
