// Fused fixed-iteration ADMM with a per-scenario scaled constraint
// matrix A_s (materialized, (m, n) per scenario), float32.
//
// Replaces the TPU kernel a1_qp_mpc_controller_tpu/ops/pallas_kernels.py
// :275 fused_admm (body _fused_admm_kernel, :239): same operands, same
// update, all `iters` iterations inside one launch:
//   w   = rho z - y
//   rhs = sigma x - q + A' w
//   xt  = minv rhs             (a reduction along minv's rows: minv is
//                               not assumed symmetric; on the legacy
//                               route it may come from torch.linalg.inv)
//   x   = alpha xt + (1 - alpha) x
//   ax  = A xt
//   zp  = alpha ax + (1 - alpha) z
//   z'  = clip(zp + y / rho, l, u)
//   y   = y + rho (zp - z')
// The TPU version pads n and m to 128 lanes with rho = 1, l = u = 0
// rows; this one takes the exact shapes (n = 120, m = 200 on the MPC),
// so no padded row can meet a swing row's infinite bound.
//
// Bound on an H100 SXM: per iteration two (m x n) products with A and
// one n x n matvec, (4 m n + 2 n^2) ~ 125 kFLOP per scenario when A is
// counted dense; at B = 1024 and 25 iterations ~3.2 GFLOP (float32
// outside the tensor cores, 67 TFLOP/s: ~0.048 ms) against ~164 MB read
// once (minv 57.6 KB and A 96 KB per scenario: ~0.049 ms), so bytes and
// operations bound it about equally.
//
// Design: one thread block per scenario, with minv and A both in dynamic
// shared memory for all iterations (57.6 + 96 KB + 7.5 KB of vectors =
// 161 KB at n = 120, m = 200): device memory sees each operand once.
// Streaming A through the read-only cache instead (as K2 does with its
// shared A0/A1) would re-read 96 KB per scenario twice per iteration,
// and unlike K2's A0/A1 the per-scenario A of a whole batch (98 MB at
// B = 1024) does not stay in the 50 MB L2. With one block per SM, the
// block has 512 threads. The A'-product runs one thread per column
// (coalesced over columns), the minv and A products one warp per row
// with a shuffle reduction. Plain IEEE float32: no TF32, no fast-math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
fused_admm_kernel(const float* __restrict__ minv, const float* __restrict__ a,
                  const float* __restrict__ q, const float* __restrict__ l,
                  const float* __restrict__ u, const float* __restrict__ rho,
                  const float* __restrict__ x0, const float* __restrict__ y0,
                  const float* __restrict__ z0, float* __restrict__ xo,
                  float* __restrict__ yo, float* __restrict__ zo, int n,
                  int m, int iters, float sigma, float alpha,
                  float one_minus_alpha) {
  extern __shared__ float smem[];
  float* s_minv = smem;           // n*n
  float* s_a = s_minv + n * n;    // m*n
  float* s_x = s_a + m * n;       // n
  float* s_q = s_x + n;           // n
  float* s_rhs = s_q + n;         // n
  float* s_xt = s_rhs + n;        // n
  float* s_y = s_xt + n;          // m
  float* s_z = s_y + m;           // m
  float* s_l = s_z + m;           // m
  float* s_u = s_l + m;           // m
  float* s_rho = s_u + m;         // m
  float* s_irho = s_rho + m;      // m  1 / rho
  float* s_w = s_irho + m;        // m  rho z - y

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t vn = static_cast<size_t>(b) * n;
  const size_t vm = static_cast<size_t>(b) * m;
  const float* g_minv = minv + static_cast<size_t>(b) * n * n;
  const float* g_a = a + static_cast<size_t>(b) * m * n;
  for (int idx = tid; idx < n * n; idx += blockDim.x) s_minv[idx] = g_minv[idx];
  for (int idx = tid; idx < m * n; idx += blockDim.x) s_a[idx] = g_a[idx];
  for (int j = tid; j < n; j += blockDim.x) {
    s_x[j] = x0[vn + j];
    s_q[j] = q[vn + j];
  }
  for (int i = tid; i < m; i += blockDim.x) {
    s_y[i] = y0[vm + i];
    s_z[i] = z0[vm + i];
    s_l[i] = l[vm + i];
    s_u[i] = u[vm + i];
    s_rho[i] = rho[vm + i];
    s_irho[i] = 1.0f / rho[vm + i];
  }
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  for (int it = 0; it < iters; ++it) {
    for (int i = tid; i < m; i += blockDim.x) {
      s_w[i] = s_rho[i] * s_z[i] - s_y[i];
    }
    __syncthreads();
    for (int j = tid; j < n; j += blockDim.x) {
      float acc = 0.0f;
      for (int i = 0; i < m; ++i) acc += s_a[i * n + j] * s_w[i];
      s_rhs[j] = sigma * s_x[j] - s_q[j] + acc;
    }
    __syncthreads();
    for (int i = warp; i < n; i += kWarps) {
      float p = 0.0f;
      for (int j = lane; j < n; j += 32) p += s_minv[i * n + j] * s_rhs[j];
      p = warp_sum(p);
      if (lane == 0) {
        s_xt[i] = p;
        s_x[i] = alpha * p + one_minus_alpha * s_x[i];
      }
    }
    __syncthreads();
    for (int i = warp; i < m; i += kWarps) {
      float p = 0.0f;
      for (int j = lane; j < n; j += 32) p += s_a[i * n + j] * s_xt[j];
      p = warp_sum(p);
      if (lane == 0) {
        const float zp = alpha * p + one_minus_alpha * s_z[i];
        const float z1 = fminf(fmaxf(zp + s_y[i] * s_irho[i], s_l[i]),
                               s_u[i]);
        s_y[i] = s_y[i] + s_rho[i] * (zp - z1);
        s_z[i] = z1;
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < n; j += blockDim.x) xo[vn + j] = s_x[j];
  for (int i = tid; i < m; i += blockDim.x) {
    yo[vm + i] = s_y[i];
    zo[vm + i] = s_z[i];
  }
}

}  // namespace

extern "C" size_t fused_admm_smem_bytes(int n, int m) {
  return static_cast<size_t>(n * n + m * n + 4 * n + 7 * m) * sizeof(float);
}

// minv: (batch, n, n); a: (batch, m, n); q, x0, xo: (batch, n); l, u,
// rho, y0, z0, yo, zo: (batch, m). All contiguous float32 on the device.
// Returns the CUDA error code of the launch.
extern "C" int fused_admm_launch(
    const float* minv, const float* a, const float* q, const float* l,
    const float* u, const float* rho, const float* x0, const float* y0,
    const float* z0, float* xo, float* yo, float* zo, int batch, int n,
    int m, int iters, float sigma, float alpha, float one_minus_alpha,
    void* stream) {
  const size_t smem = fused_admm_smem_bytes(n, m);
  cudaError_t err = cudaFuncSetAttribute(
      fused_admm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  fused_admm_kernel<<<batch, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      minv, a, q, l, u, rho, x0, y0, z0, xo, yo, zo, n, m, iters, sigma,
      alpha, one_minus_alpha);
  return static_cast<int>(cudaGetLastError());
}
