// Batched pivot-free inverses of SPD matrices, float32: K1's Gauss-Jordan,
// and the Gauss-Jordan and the sweep-operator inverse of the TPU's
// batch-last kernels, one block a matrix of the batch-leading (B, n, n)
// input.
//
// Replaces the TPU kernels
// - a1_qp_mpc_controller_tpu/ops/pallas_kernels.py:96 batched_inverse (K1,
//   body _gj_inverse_kernel, :41): Gauss-Jordan on M and a separate
//   inverse with the "diag - 1" factor. Pivot k: d = M[k, k], f = column
//   k of M with f[k] = d - 1, every row i of both arrays becomes
//   x - f[i] * (row_k[j] * (1/d)); on row k that scales the row,
//   r - (d - 1) r / d, without a select. pallas_kernels.py:126
//   batched_inverse_small (K3, n <= 128: the reduced shapes and the Schur
//   recursion's base) runs the same body, so the same rule set.
// - a1_qp_mpc_controller_tpu/ops/pallas_retired.py:564 batched_inverse_T
//   (K6g, body _gj_inverse_T_kernel, :516): the same with f[k] = 0, then
//   row k of both set to row_k * (1/d). :213 batched_inverse_combined
//   (K6c, body _gj_combined_kernel, :171, Gauss-Jordan on [M | I] with the
//   pivot row written by a select) has this arithmetic too.
// - pallas_retired.py:902 batched_inverse_sweep_T (body
//   _sweep_inverse_T_kernel, :855) and its :638 _chunked, :741 _masked and
//   :824 _masked2 variants (bodies :593, :673, :774): the one-array sweep
//   operator, whose result is -A^-1, negated at the end. Pivot k:
//   d = w[k, k], r = row k * (1/d), c = column k (with sym_col, row k read
//   as the column); w[i, j] - c[i] * r[j] off the pivot row and column,
//   c[i] * (1/d) on column k, r on row k, -1/d at (k, k). The four TPU
//   kernels differ only in how they chunk and alias VMEM; their
//   arithmetic is this one. :489 batched_inverse_spd (K6f, body
//   _sweep_inverse_kernel, :457), the batch-leading sweep, is the same
//   sweep with sym_col.
// - pallas_retired.py:144 batched_inverse_inplace (K6b, body
//   _gj_inplace_kernel, :95): Gauss-Jordan in one working array, K6g's
//   rules but for column k, which it writes as -(c[i] * (1/d)) where K6g
//   writes 0 - c[i] * (1/d): the two differ only in the sign of a zero.
//
// Bound on an H100 SXM: a Gauss-Jordan inverse needs 2n^2(n+1) operations
// a matrix and the sweep 2n^3; at n = 120 and B = 1024 that is ~3.5 G
// (~0.053 ms at 67 TFLOP/s) against 2 x 59 MB read and written once
// (~0.035 ms at 3.35 TB/s), so operations bound them all. The multiply
// and the subtract must stay separate instructions (a fused multiply-add
// would round once where the plain versions round twice), which halves
// the float32 peak: ~0.105 ms.
//
// The designs these kernels replace streamed each pivot's arrays through
// memory: the TPU's batch-in-lanes layout carried over as (n, n, 8) tiles
// in device memory (K6g and the sweep: 7.2 and 6.9 ms at (1024, 120) on an
// H100), and K1's M and inverse in 115 KB of shared memory, one block an
// SM, two barriers and both n x n arrays read and written a pivot
// (3.98 ms).
//
// Design: one block a matrix, read straight from (B, n, n) and written
// once. Every inverse works in one array:
// - the sweep's own;
// - Gauss-Jordan's live columns of [M | I]: slot j holds M's column j for
//   j > k and the inverse's column j for j <= k. M's dead columns never
//   feed the inverse, and the inverse's columns j > k are still unit
//   columns, which each pivot would leave as they are (x - f[i] * 0). At
//   pivot k slot k turns over from M's column k (the factor column) to the
//   inverse's: 0 - f[i] * (1 * (1/d)) off row k; at (k, k) 1 * (1/d)
//   (K6g) or 1 - (d - 1) * (1 * (1/d)) (K1).
// So a pivot updates n columns, and the four rule sets (enum Rule) differ
// only in row k (r, or K1's w - (d - 1) r), column k (t, 0 - t or
// (-c[i]) * (1/d), t = c[i] * (1/d)), (k, k), the factor column (column
// k, or row k with sym_col) and the final negation. One kernel body
// serves all four.
// - n <= 128: a 16 x 16 thread grid, each thread an R x R register tile,
//   R = ceil(n / 16) (1 to 8: the matrix zero-padded to 16 R, at most 15
//   rows and columns past n), entry (ty + 16a, tx + 16b) in w[a][b], zeros
//   past n. The zeros stay zeros (x - c * 0 and 0 - 0 * r), so the
//   padding never reaches a live entry and R changes no result. The
//   pivot loop nests an unrolled a0 over the register rows and a runtime
//   p over 16 (k = 16 a0 + p), so every register index is a
//   compile-time constant and the tile stays in registers. Pivot k reads row k and column k from a double-buffered
//   staging area in shared memory (2n floats); each thread computes 1/d
//   itself from the staged diagonal. After its update the threads that own
//   row k + 1 and column k + 1 write them to the other buffer: one barrier
//   a pivot. Each R has its own minimum of resident blocks
//   (min_blocks: 8 at R <= 2, 6 at 3, 5 at 4, 4 at 5, 3 at 6, 2 at 7 and
//   8), the most whose register cap (65,536 / (256 x blocks)) still holds
//   R^2 + 2R floats and ~15 registers of indices and staging, so a small
//   tile runs more matrices an SM: at R = 8 about 96 registers, two
//   blocks an SM, so a batch of at most 264 matrices is one wave and its
//   time one block's (n pivots, each a barrier and the staged reads); at
//   R = 5 (K3's n = 66) four, 528 matrices a wave; at R = 4 (K3's n = 64)
//   five, 660; at R = 2 (n = 32, the Schur recursion's base) eight, 1,056.
// - n > 128: the working array is the output in device memory, each entry
//   owned by one thread (a warp a row, lanes along the columns), with the
//   same staging: 4n floats of shared memory, so n <= 14,528.
// Products, quotients and differences are __fmul_rn / __fsub_rn and
// 1.0f / d an IEEE division, so no fused multiply-add changes the
// rounding against the plain PyTorch versions: the results are bit-equal.
// At (1024, 120) on an H100 80GB HBM3 (700 W), chip_smoke.py reads
// 0.33 ms for K6g and the sweep (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;                  // the register kernel's grid side
constexpr int kThreads = kSide * kSide;
constexpr int kLargeThreads = 512;
constexpr int kLargeWarps = kLargeThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;

// The rule sets: K6g's Gauss-Jordan (also K6c's), the sweep (also K6f's),
// K1's Gauss-Jordan with the "diag - 1" factor on row k, and K6b's
// one-array Gauss-Jordan (K6g's but for the sign of column k's zeros).
enum class Rule { kGJ, kSweep, kK1, kInplace };

// The entry rules of pivot k, shared by both storage paths; dm1 = d - 1
// (K1 only).
__device__ __forceinline__ float off_pivot(float w, float c, float rd) {
  return __fsub_rn(w, __fmul_rn(c, rd));
}

template <Rule kRule>
__device__ __forceinline__ float pivot_row(float w, float rd, float dm1) {
  return kRule == Rule::kK1 ? off_pivot(w, dm1, rd) : rd;
}

template <Rule kRule>
__device__ __forceinline__ float pivot_column(float c, float inv_d) {
  if (kRule == Rule::kInplace) return __fmul_rn(-c, inv_d);
  const float t = __fmul_rn(c, inv_d);
  return kRule == Rule::kSweep ? t : __fsub_rn(0.0f, t);
}

template <Rule kRule>
__device__ __forceinline__ float pivot_diagonal(float inv_d, float dm1) {
  return kRule == Rule::kSweep ? -inv_d
         : kRule == Rule::kK1  ? __fsub_rn(1.0f, __fmul_rn(dm1, inv_d))
                               : inv_d;
}

// The register kernel's resident blocks an SM for its launch bounds.
constexpr int min_blocks(int r) {
  return r <= 2 ? 8 : r == 3 ? 6 : r == 4 ? 5 : r == 5 ? 4 : r == 6 ? 3 : 2;
}

// n <= 16 R: the matrix in registers.
template <int R, Rule kRule>
__global__ void __launch_bounds__(kThreads, min_blocks(R))
inverse_reg_kernel(const float* __restrict__ m, float* __restrict__ out,
                   int n, int sym_col) {
  constexpr int kPad = kSide * R;
  __shared__ float stage_row[2][kPad];
  __shared__ float stage_col[2][kPad];
  const int tx = static_cast<int>(threadIdx.x) % kSide;
  const int ty = static_cast<int>(threadIdx.x) / kSide;
  const float* src = m + blockIdx.x * static_cast<size_t>(n) * n;

  float w[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int i = ty + kSide * a;
      const int j = tx + kSide * b;
      w[a][b] = (i < n && j < n) ? src[i * n + j] : 0.0f;
    }
  }
  if (ty == 0) {
#pragma unroll
    for (int b = 0; b < R; ++b) stage_row[0][tx + kSide * b] = w[0][b];
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < R; ++a) stage_col[0][ty + kSide * a] = w[a][0];
  }
  __syncthreads();

#pragma unroll
  for (int a0 = 0; a0 < R; ++a0) {
    // the register row and column of pivot 16 (a0 + 1), the next a0's first
    constexpr int kLast = R - 1;
    const int a1 = a0 < kLast ? a0 + 1 : kLast;
#pragma unroll 1
    for (int p = 0; p < kSide && kSide * a0 + p < n; ++p) {
      const int k = kSide * a0 + p;
      const float* sr = stage_row[k & 1];
      const float* sc = sym_col ? sr : stage_col[k & 1];
      const float inv_d = 1.0f / sr[k];
      const float dm1 = kRule == Rule::kK1 ? __fsub_rn(sr[k], 1.0f) : 0.0f;
      float rd[R], c[R];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        rd[b] = __fmul_rn(sr[tx + kSide * b], inv_d);
      }
#pragma unroll
      for (int a = 0; a < R; ++a) c[a] = sc[ty + kSide * a];
      // K1's factor on row k is d - 1: the off-pivot rule then gives its
      // row rule, and its column k is overwritten below
      if (kRule == Rule::kK1 && ty == p) c[a0] = dm1;
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < R; ++b) {
          w[a][b] = off_pivot(w[a][b], c[a], rd[b]);
        }
      }
      if (kRule != Rule::kK1 && ty == p) {   // row k: register row a0
#pragma unroll
        for (int b = 0; b < R; ++b) w[a0][b] = rd[b];
      }
      if (tx == p) {             // column k: register column a0
#pragma unroll
        for (int a = 0; a < R; ++a) {
          w[a][a0] = pivot_column<kRule>(c[a], inv_d);
        }
        if (ty == p) w[a0][a0] = pivot_diagonal<kRule>(inv_d, dm1);
      }
      // stage row and column k + 1 for the next pivot
      float* nr = stage_row[(k + 1) & 1];
      float* nc = stage_col[(k + 1) & 1];
      if (p + 1 < kSide) {
        if (ty == p + 1) {
#pragma unroll
          for (int b = 0; b < R; ++b) nr[tx + kSide * b] = w[a0][b];
        }
        if (tx == p + 1) {
#pragma unroll
          for (int a = 0; a < R; ++a) nc[ty + kSide * a] = w[a][a0];
        }
      } else if (a0 < kLast) {
        if (ty == 0) {
#pragma unroll
          for (int b = 0; b < R; ++b) nr[tx + kSide * b] = w[a1][b];
        }
        if (tx == 0) {
#pragma unroll
          for (int a = 0; a < R; ++a) nc[ty + kSide * a] = w[a][a1];
        }
      }
      __syncthreads();
    }
  }

  // The store computes its offsets afresh from values the compiler cannot
  // tie to the load's: holding those through the pivots would take the
  // registers that the tile needs (and spill at R = 8).
  int i0 = ty, j0 = tx, n0 = n;
  asm volatile("" : "+r"(i0), "+r"(j0), "+r"(n0));
  float* dst = out + blockIdx.x * static_cast<size_t>(n0) * n0;
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int i = i0 + kSide * a;
      const int j = j0 + kSide * b;
      if (i < n0 && j < n0) {
        dst[i * n0 + j] = kRule == Rule::kSweep ? -w[a][b] : w[a][b];
      }
    }
  }
}

// n > 128: the working array in device memory (the output).
template <Rule kRule>
__global__ void __launch_bounds__(kLargeThreads)
inverse_large_kernel(const float* __restrict__ m, float* __restrict__ out,
                     int n, int sym_col) {
  extern __shared__ float smem[];
  // row k at smem + (k & 1) n, column k at smem + (2 + (k & 1)) n
  float* stage_col = smem + 2 * n;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* src = m + blockIdx.x * nn;
  float* w = out + blockIdx.x * nn;

  for (int i = warp; i < n; i += kLargeWarps) {
    for (int j = lane; j < n; j += 32) {
      const float v = src[i * n + j];
      w[i * n + j] = v;
      if (i == 0) smem[j] = v;
      if (j == 0) stage_col[i] = v;
    }
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const float* sr = smem + (k & 1) * n;
    const float* sc = sym_col ? sr : stage_col + (k & 1) * n;
    float* nr = smem + ((k + 1) & 1) * n;
    float* nc = stage_col + ((k + 1) & 1) * n;
    const float inv_d = 1.0f / sr[k];
    const float dm1 = kRule == Rule::kK1 ? __fsub_rn(sr[k], 1.0f) : 0.0f;
    const bool last = k == n - 1;
    for (int i = warp; i < n; i += kLargeWarps) {
      const float c = sc[i];
      for (int j = lane; j < n; j += 32) {
        const float rd = __fmul_rn(sr[j], inv_d);
        float v;
        if (i == k) {
          v = (j == k) ? pivot_diagonal<kRule>(inv_d, dm1)
                       : pivot_row<kRule>(w[i * n + j], rd, dm1);
        } else if (j == k) {
          v = pivot_column<kRule>(c, inv_d);
        } else {
          v = off_pivot(w[i * n + j], c, rd);
        }
        w[i * n + j] = (kRule == Rule::kSweep && last) ? -v : v;
        if (i == k + 1) nr[j] = v;
        if (j == k + 1) nc[i] = v;
      }
    }
    __syncthreads();
  }
}

using RegKernel = void (*)(const float*, float*, int, int);

// The register kernel for n <= 128: R = ceil(n / 16).
template <Rule kRule>
RegKernel reg_kernel(int n) {
  switch ((n + kSide - 1) / kSide) {
    case 1: return inverse_reg_kernel<1, kRule>;
    case 2: return inverse_reg_kernel<2, kRule>;
    case 3: return inverse_reg_kernel<3, kRule>;
    case 4: return inverse_reg_kernel<4, kRule>;
    case 5: return inverse_reg_kernel<5, kRule>;
    case 6: return inverse_reg_kernel<6, kRule>;
    case 7: return inverse_reg_kernel<7, kRule>;
    case 8: return inverse_reg_kernel<8, kRule>;
    default: return nullptr;
  }
}

template <Rule kRule>
int launch(const float* m, float* out, int batch, int n, int sym_col,
           void* stream) {
  if (batch == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (const RegKernel kernel = reg_kernel<kRule>(n)) {
    kernel<<<batch, kThreads, 0, s>>>(m, out, n, sym_col);
  } else {
    const size_t smem = static_cast<size_t>(4 * n) * sizeof(float);
    if (smem > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          inverse_large_kernel<kRule>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    inverse_large_kernel<kRule><<<batch, kLargeThreads, smem, s>>>(
        m, out, n, sym_col);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, out: (batch, n, n) contiguous float32 on the device; out gets the
// Gauss-Jordan inverse (K6g's and K6c's rules), m is left as it is.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int inverse_t_gj_launch(const float* m, float* out, int batch,
                                   int n, void* stream) {
  return launch<Rule::kGJ>(m, out, batch, n, 0, stream);
}

// The same for the sweep; sym_col reads the pivot column off the pivot
// row.
extern "C" int inverse_t_sweep_launch(const float* m, float* out, int batch,
                                      int n, int sym_col, void* stream) {
  return launch<Rule::kSweep>(m, out, batch, n, sym_col, stream);
}

// The same for K6b's one-array Gauss-Jordan.
extern "C" int inverse_t_inplace_launch(const float* m, float* out,
                                        int batch, int n, void* stream) {
  return launch<Rule::kInplace>(m, out, batch, n, 0, stream);
}

// The same for K1's Gauss-Jordan ("diag - 1" on row k).
extern "C" int inverse_t_k1_launch(const float* m, float* out, int batch,
                                   int n, void* stream) {
  return launch<Rule::kK1>(m, out, batch, n, 0, stream);
}

// The K1 rule set's register kernel that n (1 to 128) selects: blocks
// resident an SM by CUDA's occupancy calculator (or minus the CUDA error
// code); *regs and *local_bytes get its registers a thread and its local
// memory a thread (spills).
extern "C" int inverse_t_k1_occupancy(int n, int* regs, int* local_bytes) {
  const RegKernel kernel = reg_kernel<Rule::kK1>(n);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return blocks;
}
