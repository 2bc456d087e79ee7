// Batched rank-r panel Gauss-Jordan inverses of SPD matrices, float32:
// r pivots at a time, then one fused rank-r update of M and its inverse.
//
// Replaces two TPU kernels of a1_qp_mpc_controller_tpu/ops/pallas_retired.py:
// - :428 batched_inverse_rank (body _gj_rank_r_kernel, :240). Panel
//   k0..k0+r-1: the r pivot rows of M and of the inverse are eliminated
//   against each other in order (pivot j: row j * (1/d_j), then every other
//   panel row q becomes x - f_q * (row j * (1/d_j)), f_q its entry in
//   column k0+j); then every row i outside the panel becomes
//   x - sum_j M[i, k0+j] * panel_row_j with M's raw pre-panel columns,
//   accumulated j = 0..r-1, and the panel rows are written back.
// - :397 batched_inverse_rank_masked (body _gj_rank_masked_kernel, :314).
//   Pivot j of the panel takes row k0+j of the pre-panel M and inverse,
//   corrected by the earlier panel rows l < j (x - e_l * row_l, e_l its
//   corrected entry at column k0+l), and scales it by 1/d_j; its column is
//   column k0+j of the pre-panel M corrected by the earlier columns
//   (x - col_l * g_l, g_l = row_l's entry at column k0+j), with d_j - 1 on
//   the pivot row; then both arrays take x - sum_j col_j[i] * row_j[c],
//   accumulated j = 0..r-1, on every row (the d - 1 entries scale the
//   panel rows in place, as K1 does).
// The TPU versions pad n to a multiple of r with identity pivots; the
// wrapper does the same, since those pivots decide the panels.
//
// Bound on an H100 SXM: a Gauss-Jordan inverse's 2n^2(n+1) operations a
// matrix (~3.6 GFLOP at n = 120, B = 1024: ~0.053 ms at 67 TFLOP/s)
// against 2 x 59 MB read and written once (~0.035 ms), so operations
// bound both. The multiply and the subtract stay separate roundings, as
// in the plain versions, which halves the float32 peak: ~0.105 ms. A
// rank-r update is the shape tensor cores could take later; here it
// stays float32 on the CUDA cores (no TF32 in this port).
//
// The design this replaces for n <= 128 (kept as the wide tier) held M,
// its inverse and the panel slabs in 2n^2 + 3rn floats of shared memory
// (~127 KB at n = 120, one block an SM), read and wrote both n x n arrays
// every panel, took two barriers a pivot and, in K6e, left the block
// waiting on thread 0 for each pivot's O(r^2) corrections: 2.38 / 1.86 ms
// (K6d, r = 2 / 4) and 1.92 / 2.10 ms (K6e, r = 4 / 8) at (1024, 120) on
// an H100 80GB HBM3 (700 W).
//
// Design for n <= 128: the register tile of csrc/inverse_t.cu. One block a
// matrix, read straight from (B, n, n) and written once; a 16 x 16 thread
// grid, each thread an R x R register tile (R = 2, 4 or 8, the smallest
// with 16 R >= n), entry (ty + 16a, tx + 16b) in w[a][b], zeros past n.
// - One array, the live columns of [M | I]. Before panel [k0, k0 + r)
//   slot c holds the inverse's column c for c < k0 and M's column c for
//   c >= k0. The inverse's columns from k0 + r on are still unit columns,
//   which every panel leaves as they are (x - f * 0), and M's columns
//   below k0 feed nothing later: every column evolves from its own
//   entries and M's panel columns. So the panel's r slots turn over from
//   M's columns (the factors) to the inverse's, which start as unit
//   columns. Panels never straddle a register row or column (r | 16).
// - A panel, three barriers: (1) the threads holding the panel's rows
//   and columns stage them raw into shared memory (an r x 16R slab and
//   a 16R x r column block, double-buffered, so the previous panel's
//   update may still read the other copy); (2) one warp eliminates the
//   r x r block of M where they meet, a lane a column and the pivots'
//   entries passed by warp shuffles, and leaves the panel's factors,
//   1/d and (K6e) the corrections e_jl, d_j and the block's scaled rows
//   in shared memory; (3) a thread a slot column carries the slab through
//   the panel's pivots in registers (the turnover slots start from the
//   inverse's unit columns) and, in K6e, a thread a row corrects the
//   column block: no thread waits on another within a panel. Then each
//   thread applies the fused rank-r update to its own register entries,
//   x - f[i][q] * row_q[c] for q = 0 .. r-1 in order (K6d: rows outside
//   the panel, the panel rows then take the slab; K6e: every row).
// - Resident blocks an SM: at least 2 at R = 8 (128 registers a thread),
//   4 at R = 2 and 4 (64).
// n > 128: the wide tier, up to the shared memory's 2n^2 + 3rn floats.
// Products, quotients and differences are __fmul_rn / __fsub_rn and 1.0f
// / d an IEEE division in the plain versions' order, so no fused
// multiply-add changes the rounding: both tiers are bit-equal to the
// plain PyTorch versions.

#include <cuda_runtime.h>

namespace {

constexpr int kSide = 16;                 // the register tier's grid side
constexpr int kThreads = kSide * kSide;
constexpr int kWideThreads = 512;
constexpr unsigned kFull = 0xffffffffu;

// Resident blocks an SM for the launch bounds: the register cap
// (65,536 / (256 x blocks)) holds R^2 + 2R floats of tile and operands
// besides the panel's r-float rows and the warp's r x r block.
constexpr int min_blocks(int r) { return r <= 4 ? 4 : 2; }

// The register tier. kMasked: K6e's corrected panel, else K6d's.
template <int R, int kRank, bool kMasked>
__global__ void __launch_bounds__(kThreads, min_blocks(R))
rank_reg_kernel(const float* __restrict__ m, float* __restrict__ out,
                int n) {
  constexpr int kPad = kSide * R;
  // slab[buf][j][c]: row k0 + j of the one array (raw, then the panel's
  // scaled rows); fcol[buf][j][i]: M's raw column k0 + j (K6e: then the
  // corrected columns)
  __shared__ float slab[2][kRank][kPad];
  __shared__ float fcol[2][kRank][kPad];
  __shared__ float c_fac[kRank][kRank];   // K6d: f_q of pivot j; K6e: e_jl
  __shared__ float c_inv[kRank];          // 1 / d_j
  __shared__ float c_d[kRank];            // K6e: d_j
  __shared__ float c_blk[kRank][kRank];   // K6e: scaled row j at k0 + q
  const int tid = static_cast<int>(threadIdx.x);
  const int tx = tid % kSide;
  const int ty = tid / kSide;
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

#pragma unroll
  for (int a0 = 0; a0 < R; ++a0) {
#pragma unroll 1
    for (int p0 = 0; p0 < kSide && kSide * a0 + p0 < n; p0 += kRank) {
      const int k0 = kSide * a0 + p0;
      const int buf = (k0 / kRank) & 1;
      float (*s)[kPad] = slab[buf];
      float (*f)[kPad] = fcol[buf];
      const int prow = ty - p0;          // this thread's panel row, if any
      const int pcol = tx - p0;          // its panel column (slot), if any
      const bool in_row = prow >= 0 && prow < kRank;
      const bool in_col = pcol >= 0 && pcol < kRank;
      // (1) stage the panel's rows and M's panel columns, raw
      if (in_row) {
#pragma unroll
        for (int b = 0; b < R; ++b) s[prow][tx + kSide * b] = w[a0][b];
      }
      if (in_col) {
#pragma unroll
        for (int a = 0; a < R; ++a) f[pcol][ty + kSide * a] = w[a][a0];
      }
      __syncthreads();
      // (2) the r x r block of M, a lane a column
      if (tid < 32) {
        const int q = tid < kRank ? tid : 0;
        float col[kRank];
#pragma unroll
        for (int j = 0; j < kRank; ++j) col[j] = s[j][k0 + q];
        if constexpr (!kMasked) {
#pragma unroll
          for (int j = 0; j < kRank; ++j) {
            const float inv_p = 1.0f / __shfl_sync(kFull, col[j], j);
            float fac[kRank];
#pragma unroll
            for (int r = 0; r < kRank; ++r) {
              fac[r] = __shfl_sync(kFull, col[r], j);
            }
            const float rm = __fmul_rn(col[j], inv_p);
#pragma unroll
            for (int r = 0; r < kRank; ++r) {
              if (r != j) col[r] = __fsub_rn(col[r], __fmul_rn(fac[r], rm));
            }
            col[j] = rm;
            if (tid == 0) {
              c_inv[j] = inv_p;
#pragma unroll
              for (int r = 0; r < kRank; ++r) c_fac[j][r] = fac[r];
            }
          }
        } else {
          float rows[kRank];             // scaled row j at column k0 + q
#pragma unroll
          for (int j = 0; j < kRank; ++j) {
            float v = col[j];
#pragma unroll
            for (int l = 0; l < j; ++l) {
              const float e = __shfl_sync(kFull, v, l);
              v = __fsub_rn(v, __fmul_rn(e, rows[l]));
              if (tid == 0) c_fac[j][l] = e;
            }
            const float d = __shfl_sync(kFull, v, j);
            const float inv_d = 1.0f / d;
            rows[j] = __fmul_rn(v, inv_d);
            if (tid < kRank) c_blk[j][q] = rows[j];
            if (tid == 0) {
              c_d[j] = d;
              c_inv[j] = inv_d;
            }
          }
        }
      }
      __syncthreads();
      // (3) the slab through the panel's pivots, a thread a slot column;
      //     K6e: the corrected columns, a thread a row
      if (tid < kPad) {
        const int c = tid;
        const int q = c - k0;            // the turnover slot's column
        float v[kRank];
#pragma unroll
        for (int j = 0; j < kRank; ++j) {
          v[j] = (q >= 0 && q < kRank) ? (q == j ? 1.0f : 0.0f) : s[j][c];
        }
        if constexpr (!kMasked) {
#pragma unroll
          for (int j = 0; j < kRank; ++j) {
            const float rm = __fmul_rn(v[j], c_inv[j]);
#pragma unroll
            for (int r = 0; r < kRank; ++r) {
              if (r != j) v[r] = __fsub_rn(v[r], __fmul_rn(c_fac[j][r], rm));
            }
            v[j] = rm;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kRank; ++j) {
            float x = v[j];
#pragma unroll
            for (int l = 0; l < j; ++l) {
              x = __fsub_rn(x, __fmul_rn(c_fac[j][l], v[l]));
            }
            v[j] = __fmul_rn(x, c_inv[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < kRank; ++j) s[j][c] = v[j];
      } else if (kMasked && tid >= kThreads / 2
                 && tid - kThreads / 2 < kPad) {
        const int i = tid - kThreads / 2;
        float v[kRank];
#pragma unroll
        for (int j = 0; j < kRank; ++j) {
          float x = f[j][i];
#pragma unroll
          for (int l = 0; l < j; ++l) {
            x = __fsub_rn(x, __fmul_rn(v[l], c_blk[l][j]));
          }
          v[j] = (i == k0 + j) ? __fsub_rn(c_d[j], 1.0f) : x;
        }
#pragma unroll
        for (int j = 0; j < kRank; ++j) f[j][i] = v[j];
      }
      __syncthreads();
      // the fused rank-r update of this thread's entries; the turnover
      // slots start from the inverse's unit columns
      if (in_col) {
#pragma unroll
        for (int a = 0; a < R; ++a) {
          w[a][a0] = (kMasked && ty + kSide * a == k0 + pcol) ? 1.0f : 0.0f;
        }
      }
#pragma unroll 1
      for (int j = 0; j < kRank; ++j) {
        float fa[R], ob[R];
#pragma unroll
        for (int a = 0; a < R; ++a) fa[a] = f[j][ty + kSide * a];
#pragma unroll
        for (int b = 0; b < R; ++b) ob[b] = s[j][tx + kSide * b];
#pragma unroll
        for (int a = 0; a < R; ++a) {
#pragma unroll
          for (int b = 0; b < R; ++b) {
            w[a][b] = __fsub_rn(w[a][b], __fmul_rn(fa[a], ob[b]));
          }
        }
      }
      if (!kMasked && in_row) {          // K6d's panel rows: the slab
#pragma unroll
        for (int b = 0; b < R; ++b) w[a0][b] = s[prow][tx + kSide * b];
      }
    }
  }

  // The store computes its offsets afresh (as in inverse_t.cu), so that
  // the pivots do not hold the load's index registers.
  int i0 = ty, j0 = tx, n0 = n;
  asm volatile("" : "+r"(i0), "+r"(j0), "+r"(n0));
  float* dst = out + blockIdx.x * static_cast<size_t>(n0) * n0;
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int i = i0 + kSide * a;
      const int j = j0 + kSide * b;
      if (i < n0 && j < n0) dst[i * n0 + j] = w[a][b];
    }
  }
}



__device__ __forceinline__ void load(const float* __restrict__ src,
                                     float* sm, float* si, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    sm[idx] = src[idx];
    si[idx] = (idx / n == idx % n) ? 1.0f : 0.0f;
  }
}

// The wide tier (n > 128): M, its inverse and the panel slabs in shared
// memory, a warp a row in the fused update.

// K6d: panel slabs eliminated in place, raw pre-panel columns.
template <int R>
__global__ void __launch_bounds__(kWideThreads)
gj_rank_kernel(const float* __restrict__ m_in, float* __restrict__ out,
               int n) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* sm = smem;            // n*n  M
  float* si = sm + nn;         // n*n  inverse
  float* pm = si + nn;         // R*n  panel rows of M
  float* pi = pm + R * n;      // R*n  panel rows of the inverse
  float* f = pi + R * n;       // n*R  pre-panel columns, 0 on panel rows
  __shared__ float fac[R];
  __shared__ float inv_p_s;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const size_t off = static_cast<size_t>(blockIdx.x) * nn;
  load(m_in + off, sm, si, n);
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += R) {
    for (int idx = threadIdx.x; idx < R * n; idx += blockDim.x) {
      pm[idx] = sm[k0 * n + idx];
      pi[idx] = si[k0 * n + idx];
      const int i = idx / R, q = idx % R;
      f[idx] = (i >= k0 && i < k0 + R) ? 0.0f : sm[i * n + k0 + q];
    }
    __syncthreads();
    for (int j = 0; j < R; ++j) {
      if (threadIdx.x < R) {
        fac[threadIdx.x] = pm[threadIdx.x * n + k0 + j];
      }
      if (threadIdx.x == 0) inv_p_s = 1.0f / pm[j * n + k0 + j];
      __syncthreads();
      const float inv_p = inv_p_s;
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        const float rm = __fmul_rn(pm[j * n + c], inv_p);
        const float ri = __fmul_rn(pi[j * n + c], inv_p);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (q == j) {
            pm[q * n + c] = rm;
            pi[q * n + c] = ri;
          } else {
            pm[q * n + c] = __fsub_rn(pm[q * n + c], __fmul_rn(fac[q], rm));
            pi[q * n + c] = __fsub_rn(pi[q * n + c], __fmul_rn(fac[q], ri));
          }
        }
      }
      __syncthreads();
    }
    for (int i = warp; i < n; i += nwarps) {
      float* rm = sm + i * n;
      float* ri = si + i * n;
      if (i >= k0 && i < k0 + R) {
        for (int c = lane; c < n; c += 32) {
          rm[c] = pm[(i - k0) * n + c];
          ri[c] = pi[(i - k0) * n + c];
        }
        continue;
      }
      float fi[R];
#pragma unroll
      for (int q = 0; q < R; ++q) fi[q] = f[i * R + q];
      for (int c = lane; c < n; c += 32) {
        float am = rm[c], ai = ri[c];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          am = __fsub_rn(am, __fmul_rn(fi[q], pm[q * n + c]));
          ai = __fsub_rn(ai, __fmul_rn(fi[q], pi[q * n + c]));
        }
        rm[c] = am;
        ri[c] = ai;
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    out[off + idx] = si[idx];
  }
}

// K6e: rows and columns corrected from the pre-panel arrays.
template <int R>
__global__ void __launch_bounds__(kWideThreads)
gj_rank_masked_kernel(const float* __restrict__ m_in,
                      float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  const int nn = n * n;
  float* sm = smem;            // n*n  M
  float* si = sm + nn;         // n*n  inverse
  float* rows_m = si + nn;     // R*n  corrected, scaled panel rows of M
  float* rows_i = rows_m + R * n;  // R*n  and of the inverse
  float* cols = rows_i + R * n;    // R*n  corrected panel columns
  __shared__ float e_s[R];
  __shared__ float d_s;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const size_t off = static_cast<size_t>(blockIdx.x) * nn;
  load(m_in + off, sm, si, n);
  __syncthreads();

  for (int k0 = 0; k0 < n; k0 += R) {
    for (int j = 0; j < R; ++j) {
      const int kj = k0 + j;
      if (threadIdx.x == 0) {
        // e_l: the row's entry at column k0+l after corrections 0..l-1;
        // d: its entry at column kj after corrections 0..j-1
        for (int l = 0; l < j; ++l) {
          float v = sm[kj * n + k0 + l];
          for (int l2 = 0; l2 < l; ++l2) {
            v = __fsub_rn(v, __fmul_rn(e_s[l2], rows_m[l2 * n + k0 + l]));
          }
          e_s[l] = v;
        }
        float v = sm[kj * n + kj];
        for (int l = 0; l < j; ++l) {
          v = __fsub_rn(v, __fmul_rn(e_s[l], rows_m[l * n + kj]));
        }
        d_s = v;
      }
      __syncthreads();
      const float d = d_s;
      const float inv_d = 1.0f / d;
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        float vm = sm[kj * n + c], vi = si[kj * n + c];
        for (int l = 0; l < j; ++l) {
          vm = __fsub_rn(vm, __fmul_rn(e_s[l], rows_m[l * n + c]));
          vi = __fsub_rn(vi, __fmul_rn(e_s[l], rows_i[l * n + c]));
        }
        rows_m[j * n + c] = __fmul_rn(vm, inv_d);
        rows_i[j * n + c] = __fmul_rn(vi, inv_d);
      }
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float v = sm[i * n + kj];
        for (int l = 0; l < j; ++l) {
          v = __fsub_rn(v, __fmul_rn(cols[l * n + i], rows_m[l * n + kj]));
        }
        cols[j * n + i] = (i == kj) ? __fsub_rn(d, 1.0f) : v;
      }
      __syncthreads();
    }
    for (int i = warp; i < n; i += nwarps) {
      float* rm = sm + i * n;
      float* ri = si + i * n;
      float ci[R];
#pragma unroll
      for (int q = 0; q < R; ++q) ci[q] = cols[q * n + i];
      for (int c = lane; c < n; c += 32) {
        float am = rm[c], ai = ri[c];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          am = __fsub_rn(am, __fmul_rn(ci[q], rows_m[q * n + c]));
          ai = __fsub_rn(ai, __fmul_rn(ci[q], rows_i[q * n + c]));
        }
        rm[c] = am;
        ri[c] = ai;
      }
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    out[off + idx] = si[idx];
  }
}

size_t smem_bytes(int n, int rank) {
  return static_cast<size_t>(2 * n * n + 3 * rank * n) * sizeof(float);
}

template <typename Kernel>
int run_wide(Kernel kernel, const float* m, float* out, int batch, int n,
             int rank, void* stream) {
  const size_t smem = smem_bytes(n, rank);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  kernel<<<batch, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      m, out, n);
  return static_cast<int>(cudaGetLastError());
}

using Kernel = void (*)(const float*, float*, int);

// The register tier's kernel for n <= 128, else null.
template <int kRank, bool kMasked>
Kernel tile_kernel(int n) {
  if (n <= 2 * kSide) return rank_reg_kernel<2, kRank, kMasked>;
  if (n <= 4 * kSide) return rank_reg_kernel<4, kRank, kMasked>;
  if (n <= 8 * kSide) return rank_reg_kernel<8, kRank, kMasked>;
  return nullptr;
}

template <bool kMasked>
Kernel reg_kernel(int n, int rank) {
  switch (rank) {
    case 2: return tile_kernel<2, kMasked>(n);
    case 4: return tile_kernel<4, kMasked>(n);
    case 8: return tile_kernel<8, kMasked>(n);
    default: return nullptr;
  }
}

template <bool kMasked>
Kernel wide_kernel(int rank) {
  switch (rank) {
    case 2: return kMasked ? gj_rank_masked_kernel<2> : gj_rank_kernel<2>;
    case 4: return kMasked ? gj_rank_masked_kernel<4> : gj_rank_kernel<4>;
    case 8: return kMasked ? gj_rank_masked_kernel<8> : gj_rank_kernel<8>;
    default: return nullptr;
  }
}

template <bool kMasked>
int launch(const float* m, float* out, int batch, int n, int rank,
           void* stream) {
  if (rank <= 0 || n % rank != 0 || wide_kernel<kMasked>(rank) == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel reg = reg_kernel<kMasked>(n, rank);
  if (reg == nullptr) {
    return run_wide(wide_kernel<kMasked>(rank), m, out, batch, n, rank,
                    stream);
  }
  if (batch == 0 || n == 0) return 0;
  reg<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(m, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, out: (batch, n, n) contiguous float32 on the device, n a multiple of
// rank (2, 4 or 8): n <= 128 on the register tile, past it the wide tier.
// Return the CUDA error code of the launch (0 on success); another rank or
// a ragged n is cudaErrorInvalidValue.
extern "C" int gj_rank_launch(const float* m, float* out, int batch, int n,
                              int rank, void* stream) {
  return launch<false>(m, out, batch, n, rank, stream);
}

extern "C" int gj_rank_masked_launch(const float* m, float* out, int batch,
                                     int n, int rank, void* stream) {
  return launch<true>(m, out, batch, n, rank, stream);
}

// The register tier's kernel that n (1 to 128), rank and masked select:
// blocks resident an SM by CUDA's occupancy calculator (or minus the CUDA
// error code); *regs and *local_bytes get its registers a thread and its
// local memory a thread (spills).
extern "C" int gj_rank_occupancy(int n, int rank, int masked, int* regs,
                                 int* local_bytes) {
  const Kernel kernel = masked ? reg_kernel<true>(n, rank)
                               : reg_kernel<false>(n, rank);
  if (kernel == nullptr || n < 1) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
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
