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
// bound both. A rank-r update is the shape tensor cores could take later;
// here it stays float32 on the CUDA cores (no TF32 in this port).
//
// Design: one thread block per matrix. M, its inverse and the r x n
// panel slabs live in dynamic shared memory (2n^2 + 3rn floats: ~127 KB at
// n = 120, r = 8). The panel's sequential elimination works on the slabs,
// a thread a column, two barriers a pivot; the fused update is one pass
// over both arrays a panel, a warp a row, so each entry is read and
// written once every r pivots instead of every pivot. __fmul_rn /
// __fsub_rn and an IEEE 1.0f / d keep the rounding of the plain PyTorch
// versions, which do the same operations in the same order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ void load(const float* __restrict__ src,
                                     float* sm, float* si, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    sm[idx] = src[idx];
    si[idx] = (idx / n == idx % n) ? 1.0f : 0.0f;
  }
}

// K6d: panel slabs eliminated in place, raw pre-panel columns.
template <int R>
__global__ void __launch_bounds__(kThreads)
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
__global__ void __launch_bounds__(kThreads)
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
int run(Kernel kernel, const float* m, float* out, int batch, int n,
        int rank, void* stream) {
  const size_t smem = smem_bytes(n, rank);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      m, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, out: (batch, n, n) contiguous float32 on the device, n a multiple of
// rank (2, 4 or 8). Return the CUDA error code of the launch (0 on
// success); another rank or a ragged n is cudaErrorInvalidValue.
extern "C" int gj_rank_launch(const float* m, float* out, int batch, int n,
                              int rank, void* stream) {
  if (n % rank != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (rank) {
    case 2: return run(gj_rank_kernel<2>, m, out, batch, n, 2, stream);
    case 4: return run(gj_rank_kernel<4>, m, out, batch, n, 4, stream);
    case 8: return run(gj_rank_kernel<8>, m, out, batch, n, 8, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gj_rank_masked_launch(const float* m, float* out, int batch,
                                     int n, int rank, void* stream) {
  if (n % rank != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (rank) {
    case 2: return run(gj_rank_masked_kernel<2>, m, out, batch, n, 2,
                       stream);
    case 4: return run(gj_rank_masked_kernel<4>, m, out, batch, n, 4,
                       stream);
    case 8: return run(gj_rank_masked_kernel<8>, m, out, batch, n, 8,
                       stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
