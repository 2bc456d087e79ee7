// Batched pivot-free inverses of SPD matrices in the batch-last layout
// (n, n, B), float32: a Gauss-Jordan and a sweep-operator kernel.
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
// a matrix and the sweep 2n^3; at n = 120 and B = 1024 that is ~3.6 GFLOP
// (~0.053 ms at 67 TFLOP/s) against 2 x 59 MB read and written once
// (~0.035 ms at 3.35 TB/s), so operations bound both. This design is far
// from that: the working arrays (59 MB each at that size) exceed the
// 50 MB L2, so every pivot streams the live part of them through the
// memory system, n^2 B floats read and written a pivot (~14 GB in all).
//
// Design: the TPU kept 128 scenarios in the lanes of (n, n, 128) blocks;
// here a tile is (n, n, 8) with the tiles stored one after another, so
// that (i, j) of a tile's 8 scenarios is one 32-byte sector and four
// neighbouring (i, j) one 128-byte line (the wrapper lays the batch out
// so, padding it to a multiple of 8). A block owns a tile (B / 8 blocks:
// 128 at B = 1024, about one per SM) and runs the n pivots in a loop, two
// barriers each: its 1024 threads first stage the scaled pivot row and
// the pivot column in shared memory (2 n x 8 floats), then update the
// live entries, a warp a row and four columns of the row at once, 8 loads
// in flight a thread. Odd pivots walk the rows and columns backwards, so
// that a pivot starts on the lines the last one touched last, which are
// the likeliest still in L2. Gauss-Jordan updates only the live columns
// of [M | I]: M's columns j > k and the inverse's columns j <= k (M's
// dead columns never feed the inverse; the inverse's columns j > k would
// each subtract f[i] * 0, which is exact while the pivots stay finite).
// The sweep updates the whole array and writes the last pivot negated.
// Products, quotients and differences are __fmul_rn / __fsub_rn and
// 1.0f / d an IEEE division, so no fused multiply-add changes the
// rounding against the plain PyTorch versions.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 8;                    // scenarios a tile
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32 / kLanes;           // columns a warp takes at once
constexpr int kSlots = kThreads / kLanes;    // pivot entries staged at once
constexpr int kDepth = 8;                    // loads in flight a thread

// A thread's place in its block's tile: scenario s, the column c0 of each
// group of kCols it takes, its warp, and its slot for staging.
struct Place {
  int s, c0, warp, q;
  bool active;
};

__device__ __forceinline__ Place place(int batch) {
  const int lane = threadIdx.x % 32;
  const int tid = static_cast<int>(threadIdx.x);
  return Place{lane % kLanes, lane / kLanes, tid / 32, tid / kLanes,
               static_cast<int>(blockIdx.x) * kLanes + lane % kLanes < batch};
}

// The t-th of n rows or columns: forwards on even pivots, backwards on
// odd ones.
__device__ __forceinline__ int nth(int t, int n, int k) {
  return (k & 1) ? n - 1 - t : t;
}

__global__ void __launch_bounds__(kThreads)
gj_inverse_t_kernel(float* __restrict__ m, float* __restrict__ inv, int n,
                    int batch) {
  extern __shared__ float smem[];
  float* row = smem;               // n x kLanes: live pivot row * (1/d)
  float* fac = row + n * kLanes;   // n x kLanes: column k of M
  const Place t = place(batch);
  const size_t tile = static_cast<size_t>(blockIdx.x) * n * n * kLanes;
  m += tile;
  inv += tile;
  // entry (i, j) of this thread's scenario
  auto at = [n, &t](int i, int j) { return (i * n + j) * kLanes + t.s; };

  if (t.active) {
    for (int idx = t.q; idx < n * n; idx += kSlots) {
      inv[idx * kLanes + t.s] = (idx / n == idx % n) ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    if (t.active) {
      const float inv_d = 1.0f / m[at(k, k)];
      for (int v = t.q; v < n; v += kSlots) {
        row[v * kLanes + t.s] =
            __fmul_rn(v <= k ? inv[at(k, v)] : m[at(k, v)], inv_d);
        fac[v * kLanes + t.s] = m[at(v, k)];
      }
    }
    __syncthreads();
    if (t.active) {
      for (int ii = t.warp; ii < n; ii += kWarps) {
        const int i = nth(ii, n, k);
        const float f = fac[i * kLanes + t.s];
        for (int v0 = t.c0; v0 < n; v0 += kCols * kDepth) {
          int off[kDepth];
          float val[kDepth];
#pragma unroll
          for (int u = 0; u < kDepth; ++u) {
            const int vv = v0 + u * kCols;
            off[u] = -1;
            if (vv < n) {
              const int v = nth(vv, n, k);
              off[u] = at(i, v);
              const float r = row[v * kLanes + t.s];
              const float* src = v <= k ? inv : m;
              val[u] = (i == k) ? r
                                : __fsub_rn(src[off[u]], __fmul_rn(f, r));
              if (v <= k) off[u] = -2 - off[u];    // the inverse's column
            }
          }
#pragma unroll
          for (int u = 0; u < kDepth; ++u) {
            if (off[u] >= 0) m[off[u]] = val[u];
            if (off[u] < -1) inv[-2 - off[u]] = val[u];
          }
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_inverse_t_kernel(float* __restrict__ w, int n, int batch, int sym_col) {
  extern __shared__ float smem[];
  float* row = smem;               // n x kLanes: pivot row * (1/d)
  float* col = row + n * kLanes;   // n x kLanes: pivot column
  const Place t = place(batch);
  w += static_cast<size_t>(blockIdx.x) * n * n * kLanes;
  auto at = [n, &t](int i, int j) { return (i * n + j) * kLanes + t.s; };

  for (int k = 0; k < n; ++k) {
    float inv_d = 0.0f;
    if (t.active) {
      inv_d = 1.0f / w[at(k, k)];
      for (int v = t.q; v < n; v += kSlots) {
        const float rk = w[at(k, v)];
        row[v * kLanes + t.s] = __fmul_rn(rk, inv_d);
        col[v * kLanes + t.s] = sym_col ? rk : w[at(v, k)];
      }
    }
    __syncthreads();
    if (t.active) {
      const bool last = k == n - 1;
      for (int ii = t.warp; ii < n; ii += kWarps) {
        const int i = nth(ii, n, k);
        const float c = col[i * kLanes + t.s];
        for (int v0 = t.c0; v0 < n; v0 += kCols * kDepth) {
          int off[kDepth];
          float val[kDepth];
#pragma unroll
          for (int u = 0; u < kDepth; ++u) {
            const int vv = v0 + u * kCols;
            off[u] = -1;
            if (vv < n) {
              const int j = nth(vv, n, k);
              off[u] = at(i, j);
              if (i == k) {
                val[u] = (j == k) ? -inv_d : row[j * kLanes + t.s];
              } else if (j == k) {
                val[u] = __fmul_rn(c, inv_d);
              } else {
                val[u] = __fsub_rn(w[off[u]],
                                   __fmul_rn(c, row[j * kLanes + t.s]));
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kDepth; ++u) {
            if (off[u] >= 0) w[off[u]] = last ? -val[u] : val[u];
          }
        }
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(int n) {
  return static_cast<size_t>(2 * n * kLanes) * sizeof(float);
}

int tiles(int batch) { return (batch + kLanes - 1) / kLanes; }

}  // namespace

// The tiles' width: the wrapper lays a batch of B out as ceil(B / this)
// tiles of (n, n, this), one after another.
extern "C" int inverse_t_lanes() { return kLanes; }

// m: (tiles, n, n, 8) contiguous float32 on the device, overwritten (the
// working copy); inv: the same shape, the inverse. Scenarios from `batch`
// on (the last tile's padding) are neither read nor written. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int inverse_t_gj_launch(float* m, float* inv, int n, int batch,
                                   void* stream) {
  if (batch == 0 || n == 0) return 0;
  gj_inverse_t_kernel<<<tiles(batch), kThreads, smem_bytes(n),
                        static_cast<cudaStream_t>(stream)>>>(m, inv, n,
                                                             batch);
  return static_cast<int>(cudaGetLastError());
}

// w: (tiles, n, n, 8) contiguous float32 on the device, overwritten by the
// inverse. Returns the CUDA error code of the launch (0 on success).
extern "C" int inverse_t_sweep_launch(float* w, int n, int batch,
                                      int sym_col, void* stream) {
  if (batch == 0 || n == 0) return 0;
  sweep_inverse_t_kernel<<<tiles(batch), kThreads, smem_bytes(n),
                           static_cast<cudaStream_t>(stream)>>>(w, n, batch,
                                                                sym_col);
  return static_cast<int>(cudaGetLastError());
}
