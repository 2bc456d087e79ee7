// Batched pivot-free inverses of SPD matrices, float32: the Gauss-Jordan
// and the sweep-operator inverse of the TPU's batch-last kernels, one
// block a matrix of the batch-leading (B, n, n) input.
//
// Replaces the TPU kernels of a1_qp_mpc_controller_tpu/ops/pallas_retired.py:
// - :564 batched_inverse_T (body _gj_inverse_T_kernel, :516): Gauss-Jordan
//   on M and a separate inverse. Pivot k: f = column k of M with f[k] = 0,
//   every row i of both arrays becomes x - f[i] * (row_k[j] * (1/d)), then
//   row k of both becomes row_k * (1/d). This is not K1's "diag - 1"
//   arithmetic.
// - :902 batched_inverse_sweep_T (body _sweep_inverse_T_kernel, :855) and
//   its :638 _chunked, :741 _masked and :824 _masked2 variants (bodies
//   :593, :673, :774): the one-array sweep operator, whose result is
//   -A^-1, negated at the end. Pivot k: d = w[k, k], r = row k * (1/d),
//   c = column k (with sym_col, row k read as the column); w[i, j] -
//   c[i] * r[j] off the pivot row and column, c[i] * (1/d) on column k,
//   r on row k, -1/d at (k, k). The four TPU kernels differ only in how
//   they chunk and alias VMEM; their arithmetic is this one.
//
// Bound on an H100 SXM: a Gauss-Jordan inverse needs 2n^2(n+1) operations
// a matrix and the sweep 2n^3; at n = 120 and B = 1024 that is ~3.5 G
// (~0.053 ms at 67 TFLOP/s) against 2 x 59 MB read and written once
// (~0.035 ms at 3.35 TB/s), so operations bound both. The multiply and the
// subtract must stay separate instructions (a fused multiply-add would
// round once where the plain versions round twice), which halves the
// float32 peak: ~0.105 ms.
//
// The design these kernels replace carried the TPU's batch-in-lanes layout
// over as (n, n, 8) tiles in device memory; every pivot streamed the live
// arrays through L2 and HBM (n^2 B floats read and written a pivot, ~14 GB
// a call, more than the 50 MB L2 holds): 7.2 ms (Gauss-Jordan) and 6.9 ms
// (sweep) at (1024, 120) on an H100, slower than torch.linalg.inv.
//
// Design: one block a matrix, read straight from (B, n, n) and written
// once. Both inverses work in one array:
// - the sweep's own;
// - Gauss-Jordan's live columns of [M | I]: slot j holds M's column j for
//   j > k and the inverse's column j for j <= k. M's dead columns never
//   feed the inverse, and the inverse's columns j > k are still unit
//   columns, which each pivot would leave as they are (x - f[i] * 0). At
//   pivot k slot k turns over from M's column k (the factor column) to the
//   inverse's: 0 - f[i] * (1 * (1/d)) off row k, 1 * (1/d) at (k, k).
// So a pivot updates n columns, and the two kernels differ only in four
// rules: column k (t or 0 - t, t = c[i] * (1/d)), (k, k) (-1/d or 1/d),
// the factor column (column k, or row k with sym_col) and the final
// negation. One kernel body serves both, with a compile-time flag.
// - n <= 128: a 16 x 16 thread grid, each thread an R x R register tile
//   (R = 1, 2, 4 or 8 for n <= 16, 32, 64, 128), entry (ty + 16a, tx + 16b)
//   in w[a][b], zeros past n. The pivot loop nests an unrolled a0 over the
//   register rows and a runtime p over 16 (k = 16 a0 + p), so every
//   register index is a compile-time constant and the tile stays in
//   registers. Pivot k reads row k and column k from a double-buffered
//   staging area in shared memory (2n floats); each thread computes 1/d
//   itself from the staged diagonal. After its update the threads that own
//   row k + 1 and column k + 1 write them to the other buffer: one barrier
//   a pivot. At R = 8: 96 registers, no spills, two blocks an SM.
// - n > 128: the working array is the output in device memory, each entry
//   owned by one thread (a warp a row, lanes along the columns), with the
//   same staging: 4n floats of shared memory, so n <= 14,528.
// Products, quotients and differences are __fmul_rn / __fsub_rn and
// 1.0f / d an IEEE division, so no fused multiply-add changes the
// rounding against the plain PyTorch versions: the results are bit-equal.
// At (1024, 120) on an H100 80GB HBM3 (700 W), chip_smoke.py reads
// 0.33 ms for each kernel (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;                  // the register kernel's grid side
constexpr int kThreads = kSide * kSide;
constexpr int kLargeThreads = 512;
constexpr int kLargeWarps = kLargeThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;

// The entry rules of pivot k, shared by both storage paths.
__device__ __forceinline__ float off_pivot(float w, float c, float rd) {
  return __fsub_rn(w, __fmul_rn(c, rd));
}

template <bool kSweep>
__device__ __forceinline__ float pivot_column(float c, float inv_d) {
  const float t = __fmul_rn(c, inv_d);
  return kSweep ? t : __fsub_rn(0.0f, t);
}

template <bool kSweep>
__device__ __forceinline__ float pivot_diagonal(float inv_d) {
  return kSweep ? -inv_d : inv_d;
}

// n <= 16 R: the matrix in registers.
template <int R, bool kSweep>
__global__ void __launch_bounds__(kThreads, 2)
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
      float rd[R], c[R];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        rd[b] = __fmul_rn(sr[tx + kSide * b], inv_d);
      }
#pragma unroll
      for (int a = 0; a < R; ++a) c[a] = sc[ty + kSide * a];
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < R; ++b) {
          w[a][b] = off_pivot(w[a][b], c[a], rd[b]);
        }
      }
      if (ty == p) {             // row k: register row a0
#pragma unroll
        for (int b = 0; b < R; ++b) w[a0][b] = rd[b];
      }
      if (tx == p) {             // column k: register column a0
#pragma unroll
        for (int a = 0; a < R; ++a) {
          w[a][a0] = pivot_column<kSweep>(c[a], inv_d);
        }
        if (ty == p) w[a0][a0] = pivot_diagonal<kSweep>(inv_d);
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
      if (i < n0 && j < n0) dst[i * n0 + j] = kSweep ? -w[a][b] : w[a][b];
    }
  }
}

// n > 128: the working array in device memory (the output).
template <bool kSweep>
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
    const bool last = k == n - 1;
    for (int i = warp; i < n; i += kLargeWarps) {
      const float c = sc[i];
      for (int j = lane; j < n; j += 32) {
        const float rd = __fmul_rn(sr[j], inv_d);
        float v;
        if (i == k) {
          v = (j == k) ? pivot_diagonal<kSweep>(inv_d) : rd;
        } else if (j == k) {
          v = pivot_column<kSweep>(c, inv_d);
        } else {
          v = off_pivot(w[i * n + j], c, rd);
        }
        w[i * n + j] = (kSweep && last) ? -v : v;
        if (i == k + 1) nr[j] = v;
        if (j == k + 1) nc[i] = v;
      }
    }
    __syncthreads();
  }
}

template <bool kSweep>
int launch(const float* m, float* out, int batch, int n, int sym_col,
           void* stream) {
  if (batch == 0 || n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kSide) {
    inverse_reg_kernel<1, kSweep><<<batch, kThreads, 0, s>>>(m, out, n,
                                                             sym_col);
  } else if (n <= 2 * kSide) {
    inverse_reg_kernel<2, kSweep><<<batch, kThreads, 0, s>>>(m, out, n,
                                                             sym_col);
  } else if (n <= 4 * kSide) {
    inverse_reg_kernel<4, kSweep><<<batch, kThreads, 0, s>>>(m, out, n,
                                                             sym_col);
  } else if (n <= 8 * kSide) {
    inverse_reg_kernel<8, kSweep><<<batch, kThreads, 0, s>>>(m, out, n,
                                                             sym_col);
  } else {
    const size_t smem = static_cast<size_t>(4 * n) * sizeof(float);
    if (smem > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          inverse_large_kernel<kSweep>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    inverse_large_kernel<kSweep><<<batch, kLargeThreads, smem, s>>>(
        m, out, n, sym_col);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, out: (batch, n, n) contiguous float32 on the device; out gets the
// Gauss-Jordan inverse, m is left as it is. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int inverse_t_gj_launch(const float* m, float* out, int batch,
                                   int n, void* stream) {
  return launch<false>(m, out, batch, n, 0, stream);
}

// The same for the sweep; sym_col reads the pivot column off the pivot
// row.
extern "C" int inverse_t_sweep_launch(const float* m, float* out, int batch,
                                      int n, int sym_col, void* stream) {
  return launch<true>(m, out, batch, n, sym_col, stream);
}
