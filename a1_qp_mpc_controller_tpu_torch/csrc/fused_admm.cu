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
// Bound on an H100 SXM: minv (57.6 KB) and A (96 KB) read once a scenario,
// ~157 MB at B = 1024 (~0.047 ms at 3.35 TB/s), against the operations,
// counted by A's nonzeros (the friction pyramid of models/srb.py has 2
// a row at most, 360 of 24,000): ~33 kFLOP an iteration and scenario,
// ~0.84 GFLOP at B = 1024 and 25 iterations (~0.013 ms). Bytes bound it.
//
// The design this one replaces kept minv and a dense A in 161 KB of shared
// memory (one block an SM, eight waves at B = 1024) and ran both A
// products over every entry, a 200-step serial chain a column: 2.59 ms at
// (1024, 25) on an H100.
//
// Design: one 512-thread block a scenario, A read once from device memory.
// - Packing, no host read. In its prologue each block reads its A once,
//   coalesced (a warp a row, 32 columns a load, four rows a warp in
//   flight), and writes into shared memory each row's nonzeros (column,
//   value) in ascending column, into kRowSlots slots (ballot and
//   popcount), and appends each to its column's list (row, value), up to
//   kColSlots (a shared-memory atomic; each list is then sorted by row).
//   Unused slots hold a sentinel: index n (a row's) or m (a column's) of
//   a vector whose entry there is +0, value 0. The slots are the friction
//   pyramid's widths: 2 a row (fx or fy with mu fz, or fz alone), 5 a
//   column (fz in five rows of its block). A block whose A has a longer
//   row or column (__syncthreads_or over the counts) runs the dense order
//   of the design it replaces instead, reading A from device memory; the
//   branch is uniform per block and the result right for any A. Each
//   block writes which one it ran (dense_out).
// - minv in registers at n <= 128: the dense design's thread mapping, warp
//   w the rows i = w (mod 16), lane L the columns L, L + 32, ..., so 8 x 4
//   floats a thread; two blocks an SM. Past n = 128 minv sits in shared
//   memory (the <false> instantiation) and the wrapper's contract does
//   not narrow.
// - Three barriers an iteration: (1) each column's A'-sum and rhs, a
//   thread a column; (2) minv rhs and the x update; (3) each row's A
//   product, the z / y update and the next iteration's w, a thread a row.
// - The dense design's arithmetic, bit for bit (x, y and z) on finite
//   operands:
//   - A' w: the dense loop's ascending-row fmaf chain over the column's
//     nonzeros. Its zero terms added +0 to a sum that starts at +0 and is
//     never -0, as do the sentinels.
//   - minv rhs: each lane's fmaf chain over its columns, then the xor
//     butterfly (16, 8, 4, 2, 1) of the dense warp sum, taken for eight
//     rows at once by halving the rows a lane keeps at each of the first
//     three steps (9 shuffles where eight butterflies take 40). Each add
//     pairs the same two partial sums as the dense tree did.
//   - A xt: the dense design summed a row by lane chains over columns
//     L, L + 32, ... and the butterfly. With nonzeros at j1 < j2 only,
//     that is fmaf(a2, x2, fmaf(a1, x1, 0)) where j1 = j2 (mod 32), else
//     fmaf(a1, x1, 0) + fmaf(a2, x2, 0); a sentinel slot adds +0.
//   - The elementwise updates in the contraction nvcc chose for the dense
//     source (read off its SASS), written out in __fmaf_rn / __fmul_rn /
//     __fadd_rn / __fsub_rn so that no compiler choice parts the two:
//     w = fma(rho, z, -y), rhs = fma(x, sigma, -q) + A'w,
//     x = fma(xt, alpha, x (1 - alpha)), zp = fma(ax, alpha, z (1 - alpha)),
//     z' = clip(fma(1/rho, y, zp), l, u), y = fma(zp - z', rho, y)
//     (1/rho an IEEE division, as the dense design's was).
// Arithmetic is plain IEEE float32: no TF32, no fast-math.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowSlots = 2;     // the friction pyramid's widths: a row
constexpr int kColSlots = 5;     // and a column
constexpr int kGroupRows = 4;    // rows a warp packs at once
constexpr int kRegRows = 8;      // minv in registers: rows a warp (n <= 128)
constexpr int kRegCols = 4;      // and columns a lane; the halving steps of
                                 // the butterfly below take eight rows
constexpr int kMaxSmem = 232448; // per-block dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off /= 2) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

__host__ __device__ inline size_t round4(size_t v) { return (v + 3) & ~3ul; }

// Shared memory, in floats, each part 16-byte aligned: the lists (when
// they fit), then the fixed part. The register tier (n <= 128): minv in
// registers, rhs padded to 32 kRegCols with zeros; past it minv (n x n)
// in shared memory. A column's state is (x, q), a row's (y, z, l, u) and
// (rho, w), with an extra row m whose w is the sentinel's +0; 1 / rho is
// computed again where it is used (an IEEE division: the same bits).
struct Layout {
  size_t cols, ccnt, minv, rhs, xt, col_state, row4, row2, total;

  __host__ __device__ Layout(int n, int m, bool reg_tier, bool lists) {
    const size_t nn = n, mm = m;
    cols = lists ? 4 * mm : 0;                  // row slots: float4 x m
    ccnt = cols + (lists ? 2 * kColSlots * nn : 0);  // float2 x 5 n
    minv = round4(ccnt + (lists ? nn : 0));     // column counts: n ints
    rhs = minv + (reg_tier ? 0 : round4(nn * nn));
    xt = rhs + (reg_tier ? 32 * kRegCols : round4(nn));
    col_state = xt + round4(nn + 1);            // xt, +0 at n
    row4 = col_state + round4(2 * nn);          // float2 x n
    row2 = row4 + 4 * (mm + 1);                 // float4 x (m + 1)
    total = row2 + 2 * (mm + 1);                // float2 x (m + 1)
  }
};

// Packs the rows i0 + kWarps u (u < kGroupRows) of this scenario's A, the
// warp's lanes across the columns, kCh chunks of 32 a load group: each
// nonzero into its row's slots in ascending column, and appended to its
// column's list. Returns whether a row of the group is longer than
// kRowSlots.
template <int kCh>
__device__ __forceinline__ int pack_rows(const float* __restrict__ g_a,
                                         int n, int m, int i0, int lane,
                                         float2* s_rows, float2* s_cols,
                                         int* s_ccnt) {
  int cnt[kGroupRows] = {};
  for (int k0 = 0; k0 < n; k0 += 32 * kCh) {
    float v[kGroupRows][kCh];
#pragma unroll
    for (int u = 0; u < kGroupRows; ++u) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const int i = i0 + kWarps * u;
        const int k = k0 + lane + 32 * c;
        v[u][c] = (i < m && k < n)
                      ? __ldg(g_a + static_cast<size_t>(i) * n + k) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGroupRows; ++u) {
      const int i = i0 + kWarps * u;
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        const int k = k0 + lane + 32 * c;
        const float val = v[u][c];
        const unsigned nz = __ballot_sync(kFull, val != 0.0f);
        if (val != 0.0f) {
          const int at = cnt[u] + __popc(nz & ((1u << lane) - 1u));
          if (at < kRowSlots) {
            s_rows[kRowSlots * i + at] = make_float2(__int_as_float(k), val);
          }
          const int t = atomicAdd(s_ccnt + k, 1);
          if (t < kColSlots) {
            s_cols[t * n + k] = make_float2(__int_as_float(i), val);
          }
        }
        cnt[u] += __popc(nz);
      }
    }
  }
  int wide = 0;
#pragma unroll
  for (int u = 0; u < kGroupRows; ++u) {
    const int i = i0 + kWarps * u;
    if (i < m && lane >= cnt[u] && lane < kRowSlots) {
      s_rows[kRowSlots * i + lane] = make_float2(__int_as_float(n), 0.0f);
    }
    wide |= cnt[u] > kRowSlots;
  }
  return wide;
}

// Column j's list in ascending row, the sentinels (m, 0) last. Returns
// whether the column is longer than kColSlots.
__device__ __forceinline__ int sort_column(float2* s_cols, const int* s_ccnt,
                                           int n, int m, int j) {
  const int cnt = s_ccnt[j];
  float2 e[kColSlots];
#pragma unroll
  for (int t = 0; t < kColSlots; ++t) {
    e[t] = t < cnt ? s_cols[t * n + j]
                   : make_float2(__int_as_float(m), 0.0f);
  }
#pragma unroll
  for (int pass = 0; pass < kColSlots - 1; ++pass) {
#pragma unroll
    for (int t = 0; t < kColSlots - 1 - pass; ++t) {
      if (__float_as_int(e[t].x) > __float_as_int(e[t + 1].x)) {
        const float2 s = e[t];
        e[t] = e[t + 1];
        e[t + 1] = s;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kColSlots; ++t) s_cols[t * n + j] = e[t];
  return cnt > kColSlots;
}

// One row's z / y update from its A-product p, and its next w.
__device__ __forceinline__ void row_update(float p, int i, float alpha,
                                           float one_minus_alpha,
                                           float4* s_row4, float2* s_row2) {
  const float4 st = s_row4[i];                  // y, z, l, u
  const float rho = s_row2[i].x;
  const float zp = __fmaf_rn(p, alpha, __fmul_rn(st.y, one_minus_alpha));
  const float z1 = fminf(fmaxf(__fmaf_rn(1.0f / rho, st.x, zp), st.z), st.w);
  const float y1 = __fmaf_rn(__fsub_rn(zp, z1), rho, st.x);
  reinterpret_cast<float2*>(s_row4 + i)[0] = make_float2(y1, z1);
  s_row2[i].y = __fmaf_rn(rho, z1, -y1);
}

template <bool kReg>
__global__ void __launch_bounds__(kThreads, kReg ? 2 : 1)
fused_admm_kernel(const float* __restrict__ minv, const float* __restrict__ a,
                  const float* __restrict__ q, const float* __restrict__ l,
                  const float* __restrict__ u, const float* __restrict__ rho,
                  const float* __restrict__ x0, const float* __restrict__ y0,
                  const float* __restrict__ z0, float* __restrict__ xo,
                  float* __restrict__ yo, float* __restrict__ zo,
                  int* __restrict__ dense_out, int n, int m, int lists,
                  int iters, float sigma, float alpha,
                  float one_minus_alpha) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(n, m, kReg, lists);
  float2* s_rows = reinterpret_cast<float2*>(smem);              // 2 m
  float2* s_cols = reinterpret_cast<float2*>(smem + lay.cols);   // 5 n
  int* s_ccnt = reinterpret_cast<int*>(smem + lay.ccnt);         // n
  float* s_minv = smem + lay.minv;                 // n*n (past 128)
  float* s_rhs = smem + lay.rhs;                   // 128 or n
  float* s_xt = smem + lay.xt;                     // n + 1 (+0 at n)
  float2* s_xq = reinterpret_cast<float2*>(smem + lay.col_state);  // x, q
  float4* s_row4 = reinterpret_cast<float4*>(smem + lay.row4);  // y z l u
  float2* s_row2 = reinterpret_cast<float2*>(smem + lay.row2);  // rho, w

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t vn = static_cast<size_t>(b) * n;
  const size_t vm = static_cast<size_t>(b) * m;
  const float* g_minv = minv + static_cast<size_t>(b) * n * n;
  const float* g_a = a + static_cast<size_t>(b) * m * n;

  for (int j = tid; j < n; j += kThreads) {
    s_xq[j] = make_float2(x0[vn + j], q[vn + j]);
    if (lists) s_ccnt[j] = 0;
  }
  if (kReg) {
    for (int j = n + tid; j < 32 * kRegCols; j += kThreads) s_rhs[j] = 0.0f;
  }
  for (int i = tid; i < m; i += kThreads) {
    const float yi = y0[vm + i], zi = z0[vm + i], ri = rho[vm + i];
    s_row4[i] = make_float4(yi, zi, l[vm + i], u[vm + i]);
    s_row2[i] = make_float2(ri, __fmaf_rn(ri, zi, -yi));
  }
  if (tid == 0) {
    s_xt[n] = 0.0f;
    s_row2[m] = make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  // The lists, and whether every one fits its slots.
  int wide = 0;
  if (lists) {
    for (int i0 = warp; i0 < m; i0 += kWarps * kGroupRows) {
      wide |= pack_rows<kReg ? kRegCols : 1>(g_a, n, m, i0, lane, s_rows,
                                             s_cols, s_ccnt);
    }
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      wide |= sort_column(s_cols, s_ccnt, n, m, j);
    }
  }
  const bool sparse = !__syncthreads_or(wide) && lists;
  if (tid == 0) dense_out[b] = !sparse;

  float mreg[kRegRows][kRegCols];
  if constexpr (kReg) {
#pragma unroll
    for (int r = 0; r < kRegRows; ++r) {
#pragma unroll
      for (int c = 0; c < kRegCols; ++c) {
        const int i = warp + kWarps * r;
        const int j = lane + 32 * c;
        mreg[r][c] = (i < n && j < n)
                         ? g_minv[static_cast<size_t>(i) * n + j] : 0.0f;
      }
    }
  } else {
    for (int idx = tid; idx < n * n; idx += kThreads) {
      s_minv[idx] = g_minv[idx];
    }
    __syncthreads();
  }

  // The iterations, compiled once for each way of reading A, so that no
  // phase branches between its products and their loads overlap.
  const auto iterate = [&](auto sparse_tag) {
    constexpr bool kSparse = decltype(sparse_tag)::value;
    for (int it = 0; it < iters; ++it) {
      // (1) rhs = sigma x - q + A' w, rows ascending
      for (int j = tid; j < n; j += kThreads) {
        float acc = 0.0f;
        if constexpr (kSparse) {
#pragma unroll
          for (int t = 0; t < kColSlots; ++t) {
            const float2 e = s_cols[t * n + j];
            acc = __fmaf_rn(e.y, s_row2[__float_as_int(e.x)].y, acc);
          }
        } else {
          for (int i = 0; i < m; ++i) {
            acc = __fmaf_rn(__ldg(g_a + static_cast<size_t>(i) * n + j),
                            s_row2[i].y, acc);
          }
        }
        const float2 xq = s_xq[j];
        s_rhs[j] = __fadd_rn(__fmaf_rn(xq.x, sigma, -xq.y), acc);
      }
      __syncthreads();
      // (2) xt = minv rhs: lane chains, then the butterfly; the x update
      if constexpr (kReg) {
        float acc[kRegRows];
#pragma unroll
        for (int r = 0; r < kRegRows; ++r) acc[r] = 0.0f;
#pragma unroll
        for (int c = 0; c < kRegCols; ++c) {
          const float rv = s_rhs[lane + 32 * c];
#pragma unroll
          for (int r = 0; r < kRegRows; ++r) {
            acc[r] = __fmaf_rn(mreg[r][c], rv, acc[r]);
          }
        }
        // xor 16, 8, 4: each step keeps half the rows (by the lane's bit)
        // and adds the partner's partial sums of those rows
        const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
        float s4[4], s2[2];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float keep = h16 ? acc[t + 4] : acc[t];
          const float give = h16 ? acc[t] : acc[t + 4];
          s4[t] = __fadd_rn(keep, __shfl_xor_sync(kFull, give, 16));
        }
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float keep = h8 ? s4[t + 2] : s4[t];
          const float give = h8 ? s4[t] : s4[t + 2];
          s2[t] = __fadd_rn(keep, __shfl_xor_sync(kFull, give, 8));
        }
        float p = __fadd_rn(h4 ? s2[1] : s2[0],
                            __shfl_xor_sync(kFull, h4 ? s2[0] : s2[1], 4));
        p = __fadd_rn(p, __shfl_xor_sync(kFull, p, 2));
        p = __fadd_rn(p, __shfl_xor_sync(kFull, p, 1));
        const int i = warp + kWarps * (lane >> 2);     // this lane's row
        if ((lane & 3) == 0 && i < n) {
          s_xt[i] = p;
          s_xq[i].x = __fmaf_rn(p, alpha,
                                __fmul_rn(s_xq[i].x, one_minus_alpha));
        }
      } else {
        for (int i = warp; i < n; i += kWarps) {
          float p = 0.0f;
          for (int j = lane; j < n; j += 32) {
            p = __fmaf_rn(s_minv[i * n + j], s_rhs[j], p);
          }
          p = warp_sum(p);
          if (lane == 0) {
            s_xt[i] = p;
            s_xq[i].x = __fmaf_rn(p, alpha,
                                  __fmul_rn(s_xq[i].x, one_minus_alpha));
          }
        }
      }
      __syncthreads();
      // (3) ax = A xt; z, y and the next w
      if constexpr (kSparse) {
        for (int i = tid; i < m; i += kThreads) {
          const float4 r = reinterpret_cast<const float4*>(s_rows)[i];
          const int j1 = __float_as_int(r.x), j2 = __float_as_int(r.z);
          const float p1 = __fmaf_rn(r.y, s_xt[j1], 0.0f);
          const float p = ((j1 ^ j2) & 31) == 0
                              ? __fmaf_rn(r.w, s_xt[j2], p1)
                              : __fadd_rn(p1, __fmaf_rn(r.w, s_xt[j2], 0.0f));
          row_update(p, i, alpha, one_minus_alpha, s_row4, s_row2);
        }
      } else {
        for (int i = warp; i < m; i += kWarps) {
          float p = 0.0f;
          for (int j = lane; j < n; j += 32) {
            p = __fmaf_rn(__ldg(g_a + static_cast<size_t>(i) * n + j),
                          s_xt[j], p);
          }
          p = warp_sum(p);
          if (lane == 0) {
            row_update(p, i, alpha, one_minus_alpha, s_row4, s_row2);
          }
        }
      }
      __syncthreads();
    }
  };
  if (sparse) {
    iterate(std::true_type{});
  } else {
    iterate(std::false_type{});
  }

  for (int j = tid; j < n; j += kThreads) xo[vn + j] = s_xq[j].x;
  for (int i = tid; i < m; i += kThreads) {
    const float4 st = s_row4[i];
    yo[vm + i] = st.x;
    zo[vm + i] = st.y;
  }
}

template <bool kReg>
int launch_tier(const float* minv, const float* a, const float* q,
                const float* l, const float* u, const float* rho,
                const float* x0, const float* y0, const float* z0, float* xo,
                float* yo, float* zo, int* dense, int batch, int n, int m,
                int iters, float sigma, float alpha, float one_minus_alpha,
                cudaStream_t stream) {
  const bool lists =
      Layout(n, m, kReg, true).total * sizeof(float) <= kMaxSmem;
  const size_t smem = Layout(n, m, kReg, lists).total * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_admm_kernel<kReg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  fused_admm_kernel<kReg><<<batch, kThreads, smem, stream>>>(
      minv, a, q, l, u, rho, x0, y0, z0, xo, yo, zo, dense, n, m, lists,
      iters, sigma, alpha, one_minus_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// minv: (batch, n, n); a: (batch, m, n); q, x0, xo: (batch, n); l, u,
// rho, y0, z0, yo, zo: (batch, m); dense: (batch,) ints, 1 where the
// block ran the dense order. All contiguous on the device. Returns the
// CUDA error code of the launch.
extern "C" int fused_admm_launch(
    const float* minv, const float* a, const float* q, const float* l,
    const float* u, const float* rho, const float* x0, const float* y0,
    const float* z0, float* xo, float* yo, float* zo, int* dense, int batch,
    int n, int m, int iters, float sigma, float alpha, float one_minus_alpha,
    void* stream) {
  if (n < 0 || m < 0 || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return n <= 32 * kRegCols
             ? launch_tier<true>(minv, a, q, l, u, rho, x0, y0, z0, xo,
                                     yo, zo, dense, batch, n, m, iters, sigma,
                                     alpha, one_minus_alpha, st)
             : launch_tier<false>(minv, a, q, l, u, rho, x0, y0, z0, xo, yo, zo,
                              dense, batch, n, m, iters, sigma, alpha,
                              one_minus_alpha, st);
}
