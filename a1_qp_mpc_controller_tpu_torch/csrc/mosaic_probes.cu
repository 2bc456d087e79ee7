// The TPU compiler's lowering probes, float32, as Hopper kernels.
//
// Replaces the TPU kernels scripts/probe_mosaic.py:33 run (bodies :52-139),
// scripts/probe_mosaic2.py:28 run (bodies :46-117) and
// scripts/probe_mosaic4.py:32 probe_grid_negate (body :24). Those probes
// bisected crashes of the TPU's kernel compiler; the crashes have no
// counterpart here, what each body computes does. Every array is
// (ni, nj, S) with S lanes innermost, and the lanes are independent. The
// output w starts as the input m; step k = 0 .. n-1 of each body:
//   negate          w = -m (no loop)
//   fori_mask       w[:, k] = w[:, k] * 2
//   axis1_reduce    w[i, j] = w[i, j] - 1e-6 w[i, k]
//   axis0_reduce    w[i, j] = w[i, j] - 1e-6 w[k, j]
//   dyn_read        w[0] = m[k]
//   dyn_store       w[k] = m[0] * 2
//   carry_vec       w = w - 1e-6 r, then r = row k of w before the step
//                   (r starts at 0)
//   rank1           w[i, j] = w[i, j] - 1e-6 (w[i, k] w[k, j])
//   thin_transpose  w[i, j] = w[i, j] - 1e-6 (w[i, k] w[j, k])  (ni = nj)
//   carry_const     w = w - 1e-6 r, then r = r + 1 (r starts at 0)
//   slab_axis0      w[0] = 0 + w[k] (the TPU body's masked sum over 8-row
//                   slabs: one term is not zero)
// Each update is one __fmul_rn and one __fsub_rn (rank1 and thin_transpose
// round the product first, as the JAX bodies order it), so every kernel
// agrees bit for bit with its plain PyTorch version.
//
// Bound on an H100 SXM: the array read and written once over 3.35 TB/s,
// 0.0044 ms at (120, 120, 128), bounds every body there but rank1 and
// thin_transpose, whose 3 operations an entry a step (the product, its
// scaling, the subtraction) take 0.0099 ms at 67 TFLOP/s at n = 120;
// axis1/axis0_reduce, carry_vec and carry_const need 1 an entry a step
// (the pivot's scaling is once a row, a column or a step), 0.0033 ms.
// negate at (120, 120, 1024) moves 118 MB, 0.035 ms.
//
// Design: each body as its dependencies allow.
// - Per entry (negate, fori_mask, dyn_read, dyn_store, carry_const,
//   slab_axis0): each output entry depends on entries of m alone, so the
//   n steps fold into one elementwise pass (launch_flat): dyn_read's row 0
//   becomes m[n-1], dyn_store's rows k < n become 2 m[0], slab_axis0's
//   row 0 becomes 0 + m[n-1], fori_mask's columns j < n become 2 m, and
//   carry_const runs its n roundings w - 1e-6 r, r + 1 in each thread's
//   loop. float4 loads and stores where m and o share their offset from a
//   16-byte boundary (and, for the bodies that read another row, every
//   row is whole float4s), a scalar head and tail, a grid of 8 blocks an
//   SM by the SM count the device reports, and a grid-stride loop past
//   it.
// - Independent chains (chain_kernel): axis1_reduce's rows, axis0_reduce's
//   and carry_vec's columns are each a chain of n steps over one lane's
//   row or column, 15,360 chains at (120, 120, 128). g threads of a warp
//   (a power of two) share a chain, entry e in register e / g of thread
//   e % g; the warp's 32 / g lane groups sit side by side, so that its
//   loads take whole 32-byte sectors at g <= 4. Step k takes the pivot
//   from register k / g of thread k % g by a shuffle: no barrier and no
//   shared memory. g is the least that keeps a thread's registers at 32,
//   doubled while fewer than 256 threads an SM would run and a thread
//   keeps at least 4 (axis0 at (120, 8, 128): 1,024 chains, g = 32).
// - Fully coupled (tile_kernel): rank1 and thin_transpose read row k and
//   column k of the array they rewrite. One block a lane, a 16 x 16 grid
//   of threads, each an RI x RJ register tile (RI, RJ: ceil(ni / 16) and
//   ceil(nj / 16) rounded up to 1, 2, 4 or 8; zeros past ni and nj, never
//   stored), entry (ty + 16a, tx + 16b) in w[a][b]. The pivot loop nests
//   an unrolled a0 over the register rows and a runtime p over 16, so
//   every register index is a compile-time constant. Step k reads row k
//   and column k from a double-buffered staging area in shared memory;
//   after its update the threads that own row k + 1 and column k + 1
//   write them to the other buffer: one barrier a step (csrc/inverse_t.cu's
//   register kernel, with this update). The 128 lanes of the ladders
//   leave one block an SM, so a step's latency sets the time, about 0.7
//   us as for inverse_t.cu's pivots; a 32 x 32 grid of 4 x 4 tiles (32
//   warps) did not shorten it: rank1 at (120, 120, 128) ran 0.095 ms
//   against this grid's 0.087 on an H100 80GB HBM3 at 700 W.
// - Past 1,024 entries a chain, or 128 rows or columns for the tile, the
//   wide tier: one block a lane keeps the lane's whole array in dynamic
//   shared memory (ops/kernels_scripts.py's _check_steps bounds it), two
//   barriers a step.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py and
// tests/compare_source.py S2): see PERF.md §6's S2a and S2b rows.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;      // elementwise: 2048 threads an SM
constexpr int kUnroll = 4;           // elementwise: float4s a thread a pass
constexpr int kMaxWaves = 8;         // elementwise: the grid's cap, in
                                     // resident grids
constexpr int kSide = 16;            // the tile kernel's grid side
constexpr int kMaxTile = 8;          // its largest register tile side
constexpr int kChainFill = 256;      // threads an SM the chains aim for
constexpr int kMaxChainRegs = 32;    // a chain thread's most registers

enum Body {
  kNegate = 0,
  kForiMask = 1,
  kAxis1Reduce = 2,
  kAxis0Reduce = 3,
  kDynRead = 4,
  kDynStore = 5,
  kCarryVec = 6,
  kRank1 = 7,
  kThinTranspose = 8,
  kCarryConst = 9,
  kSlabAxis0 = 10,
};

// The bodies whose output entry reads another row of m.
__host__ __device__ constexpr bool reads_row(int b) {
  return b == kDynRead || b == kDynStore || b == kSlabAxis0;
}

__device__ __forceinline__ float minus_scaled(float w, float v) {
  return __fsub_rn(w, __fmul_rn(1e-6f, v));
}

// The per-entry bodies over the flat array. Element e lies in row
// e / (nj S) and column (e / S) mod nj. source(e): the element of m that
// output e is computed from; value(v, e): the output from it.
template <int B>
struct Entry {
  unsigned row, s, nj, n;

  __device__ __forceinline__ unsigned source(unsigned e) const {
    if (B == kDynRead || B == kSlabAxis0) {
      return (n > 0 && e < row) ? e + (n - 1) * row : e;
    }
    if (B == kDynStore) return e < n * row ? e % row : e;
    return e;
  }

  // fori_mask over every column or none needs no column index
  __device__ __forceinline__ bool scaled(unsigned e) const {
    return n >= nj || (n > 0 && e / s % nj < n);
  }

  __device__ __forceinline__ float value(float v, unsigned e) const {
    if (B == kNegate) return -v;
    if (B == kForiMask) return scaled(e) ? __fmul_rn(v, 2.0f) : v;
    if (B == kDynStore) return e < n * row ? __fmul_rn(v, 2.0f) : v;
    if (B == kSlabAxis0) {
      return (n > 0 && e < row) ? __fadd_rn(0.0f, v) : v;
    }
    return v;                                   // dyn_read
  }
};

// carry_const's n roundings on a float4: r = 0, 1, ..., each step's
// product 1e-6 r formed once for the four.
__device__ __forceinline__ float4 carry_const4(float4 w, unsigned n) {
  float r = 0.0f;
  for (unsigned k = 0; k < n; ++k) {
    const float c = __fmul_rn(1e-6f, r);
    w = make_float4(__fsub_rn(w.x, c), __fsub_rn(w.y, c), __fsub_rn(w.z, c),
                    __fsub_rn(w.w, c));
    r = __fadd_rn(r, 1.0f);
  }
  return w;
}

// The elements before the first 16-byte boundary (head) and after the
// last whole float4 (tail) go one a thread; the rest as float4s, a block
// taking kThreads U of them (U = kUnroll on large arrays, 1 on small
// ones), each thread's U loads in flight before its stores. When m and o
// sit at different offsets from a 16-byte boundary (or a body that reads
// another row has rows that are not whole float4s) the launcher sets
// head = total: every element goes alone. row4: the four elements of
// each float4 lie in one column (S % 4 == 0, head 0).
template <int B, int U>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const float* __restrict__ m, float* __restrict__ o,
                   unsigned total, unsigned head, unsigned s, unsigned nj,
                   unsigned n, bool row4) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  const Entry<B> en{nj * s, s, nj, n};
  const auto one = [&](unsigned i) {
    if (B == kCarryConst) return carry_const4(make_float4(m[i], 0, 0, 0), n).x;
    return en.value(m[en.source(i)], i);
  };
  const unsigned nvec = (total - head) / 4;
  const unsigned tail = head + 4 * nvec;
  for (unsigned i = tid; i < head; i += stride) o[i] = one(i);
  for (unsigned i = tail + tid; i < total; i += stride) o[i] = one(i);
  const float4* mv = reinterpret_cast<const float4*>(m + head);
  float4* ov = reinterpret_cast<float4*>(o + head);
  for (unsigned v0 = blockIdx.x * kThreads * U + threadIdx.x; v0 < nvec;
       v0 += stride * U) {
    float4 r[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const unsigned v = v0 + k * kThreads;
      // a body that reads another row has head 0 and whole-float4 rows
      const unsigned sv = reads_row(B) ? en.source(4 * v) / 4 : v;
      if (v < nvec) r[k] = __ldg(mv + sv);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const unsigned v = v0 + k * kThreads;
      if (v >= nvec) continue;
      const unsigned e0 = head + 4 * v;
      float4 w = r[k];
      if (B == kNegate) {
        w = make_float4(-w.x, -w.y, -w.z, -w.w);
      } else if (B == kCarryConst) {
        w = carry_const4(w, n);
      } else if (B == kForiMask && row4) {
        if (en.scaled(e0)) {
          w = make_float4(__fmul_rn(w.x, 2.0f), __fmul_rn(w.y, 2.0f),
                          __fmul_rn(w.z, 2.0f), __fmul_rn(w.w, 2.0f));
        }
      } else {
        w = make_float4(en.value(w.x, e0), en.value(w.y, e0 + 1),
                        en.value(w.z, e0 + 2), en.value(w.w, e0 + 3));
      }
      ov[v] = w;
    }
  }
}

template <int B, int U>
void launch_elementwise(const float* m, float* o, size_t total, size_t head,
                        int nj, int s, int n, size_t blocks,
                        cudaStream_t stream) {
  elementwise_kernel<B, U><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(
      m, o, static_cast<unsigned>(total), static_cast<unsigned>(head),
      static_cast<unsigned>(s), static_cast<unsigned>(nj),
      static_cast<unsigned>(n),
      head == 0 && s % 4 == 0);
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return static_cast<int>(err);
}

// The grid: a block a kThreads U float4s (or the head's and tail's
// elements, if more), at most kMaxWaves resident grids of the SM count
// the device reports, past which the blocks stride over the rest. Arrays
// of 2^31 elements or more are refused (32-bit indices).
template <int B>
int launch_flat(const float* m, float* o, int ni, int nj, int s, int n,
                cudaStream_t stream) {
  const size_t total = static_cast<size_t>(ni) * nj * s;
  if (total == 0) return 0;
  if (total >= (size_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  const size_t mo = reinterpret_cast<size_t>(m) & 15;
  size_t head = total;
  if (mo == (reinterpret_cast<size_t>(o) & 15)) {
    head = ((16 - mo) & 15) / 4;
    if (head > total) head = total;
  }
  if (reads_row(B) && (head != 0 || static_cast<size_t>(nj) * s % 4 != 0)) {
    head = total;
  }
  const size_t nvec = (total - head) / 4;
  const size_t resident = static_cast<size_t>(sms) * kBlocksPerSm;
  const bool wide = nvec >= resident * kThreads * kUnroll;
  const size_t per_block = static_cast<size_t>(kThreads)
                           * (wide ? kUnroll : 1);
  size_t blocks = (nvec + per_block - 1) / per_block;
  const size_t loose = (head + 3 + kThreads - 1) / kThreads;
  if (blocks < loose) blocks = loose;
  if (blocks > resident * kMaxWaves) blocks = resident * kMaxWaves;
  if (wide) {
    launch_elementwise<B, kUnroll>(m, o, total, head, nj, s, n, blocks,
                                   stream);
  } else {
    launch_elementwise<B, 1>(m, o, total, head, nj, s, n, blocks, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// Chains of len entries, g threads a chain, R registers a thread (g R >=
// len). Warp w takes chain row w / groups and the 32 / g lanes from
// (w mod groups) 32 / g; thread t of it lane l = t mod (32 / g) and part
// c = t / (32 / g), entries c, c + g, ... of the chain. Lanes past S
// compute on zeros and store nothing, so that every shuffle has its 32.
// axis1_reduce: chain (i, lane) over j, entry stride S; axis0_reduce and
// carry_vec: chain (j, lane) over i, stride nj S.
template <int B, int R>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const float* __restrict__ m, float* __restrict__ o, int ni,
             int nj, int s, int n, int g) {
  const int lanes = 32 / g;
  const int groups = (s + lanes - 1) / lanes;
  const int rows = B == kAxis1Reduce ? ni : nj;
  const int len = B == kAxis1Reduce ? nj : ni;
  const size_t warp = (static_cast<size_t>(blockIdx.x) * kThreads
                       + threadIdx.x) / 32;
  if (warp >= static_cast<size_t>(rows) * groups) return;  // the whole warp
  const int t = threadIdx.x % 32;
  const int l = t % lanes, c = t / lanes;
  const int row = static_cast<int>(warp / groups);
  const int lane = static_cast<int>(warp % groups) * lanes + l;
  const bool live = lane < s;
  const size_t stride = B == kAxis1Reduce ? static_cast<size_t>(s)
                                          : static_cast<size_t>(nj) * s;
  const size_t base = (B == kAxis1Reduce ? static_cast<size_t>(row) * nj * s
                                         : static_cast<size_t>(row) * s)
                      + lane;
  float w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * g + c;
    w[r] = (live && e < len) ? __ldg(m + base + e * stride) : 0.0f;
  }
  float carry = 0.0f;                           // carry_vec's r
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll 1
    for (int cc = 0; cc < g && r * g + cc < n; ++cc) {
      // pivot k = r g + cc: register r of part cc of this lane
      const float p = __shfl_sync(0xffffffffu, w[r], cc * lanes + l);
      float q;
      if (B == kCarryVec) {
        q = __fmul_rn(1e-6f, carry);
        carry = p;
      } else {
        q = __fmul_rn(1e-6f, p);
      }
#pragma unroll
      for (int rr = 0; rr < R; ++rr) w[rr] = __fsub_rn(w[rr], q);
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * g + c;
    if (e < len) o[base + e * stride] = w[r];
  }
}

// One lane a block on a 16 x 16 grid, an RI x RJ register tile a thread.
template <int B, int RI, int RJ>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ m, float* __restrict__ o, int ni,
            int nj, int s, int n) {
  constexpr int kPivots = RI < RJ ? RI : RJ;   // register rows k lies in
  __shared__ float stage_row[2][kSide * RJ];   // rank1's row k
  __shared__ float stage_col[2][kSide * RI];   // column k
  const int tx = static_cast<int>(threadIdx.x) % kSide;
  const int ty = static_cast<int>(threadIdx.x) / kSide;
  const float* src = m + blockIdx.x;
  const size_t ss = s;

  float w[RI][RJ];
#pragma unroll
  for (int a = 0; a < RI; ++a) {
#pragma unroll
    for (int b = 0; b < RJ; ++b) {
      const int i = ty + kSide * a;
      const int j = tx + kSide * b;
      w[a][b] = (i < ni && j < nj) ? __ldg(src + (i * nj + j) * ss) : 0.0f;
    }
  }
  if (B == kRank1 && ty == 0) {
#pragma unroll
    for (int b = 0; b < RJ; ++b) stage_row[0][tx + kSide * b] = w[0][b];
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < RI; ++a) stage_col[0][ty + kSide * a] = w[a][0];
  }
  __syncthreads();

#pragma unroll
  for (int a0 = 0; a0 < kPivots; ++a0) {
    constexpr int kLast = kPivots - 1;
    const int a1 = a0 < kLast ? a0 + 1 : kLast;
#pragma unroll 1
    for (int p = 0; p < kSide && kSide * a0 + p < n; ++p) {
      const int k = kSide * a0 + p;
      const float* sc = stage_col[k & 1];
      const float* sr = B == kRank1 ? stage_row[k & 1] : sc;
      float c[RI], r[RJ];
#pragma unroll
      for (int a = 0; a < RI; ++a) c[a] = sc[ty + kSide * a];
#pragma unroll
      for (int b = 0; b < RJ; ++b) r[b] = sr[tx + kSide * b];
#pragma unroll
      for (int a = 0; a < RI; ++a) {
#pragma unroll
        for (int b = 0; b < RJ; ++b) {
          w[a][b] = minus_scaled(w[a][b], __fmul_rn(c[a], r[b]));
        }
      }
      // stage row and column k + 1 for the next step
      float* nr = stage_row[(k + 1) & 1];
      float* nc = stage_col[(k + 1) & 1];
      if (p + 1 < kSide) {
        if (B == kRank1 && ty == p + 1) {
#pragma unroll
          for (int b = 0; b < RJ; ++b) nr[tx + kSide * b] = w[a0][b];
        }
        if (tx == p + 1) {
#pragma unroll
          for (int a = 0; a < RI; ++a) nc[ty + kSide * a] = w[a][a0];
        }
      } else if (a0 < kLast) {
        if (B == kRank1 && ty == 0) {
#pragma unroll
          for (int b = 0; b < RJ; ++b) nr[tx + kSide * b] = w[a1][b];
        }
        if (tx == 0) {
#pragma unroll
          for (int a = 0; a < RI; ++a) nc[ty + kSide * a] = w[a][a1];
        }
      }
      __syncthreads();
    }
  }

  float* dst = o + blockIdx.x;
#pragma unroll
  for (int a = 0; a < RI; ++a) {
#pragma unroll
    for (int b = 0; b < RJ; ++b) {
      const int i = ty + kSide * a;
      const int j = tx + kSide * b;
      if (i < ni && j < nj) dst[(i * nj + j) * ss] = w[a][b];
    }
  }
}

// The wide tier: w (ni*nj), rowk (nj), colk (ni), carry (nj) in shared
// memory, one block a lane.
template <int B>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ m, float* __restrict__ o, int ni,
             int nj, int s, int n) {
  extern __shared__ float smem[];
  const int nn = ni * nj;
  float* w = smem;
  float* rowk = w + nn;
  float* colk = rowk + nj;
  float* carry = colk + ni;
  const int t0 = threadIdx.x;
  const int ts = blockDim.x;
  const float* mk = m + blockIdx.x;          // this block's lane of m

  for (int e = t0; e < nn; e += ts) w[e] = mk[static_cast<size_t>(e) * s];
  for (int j = t0; j < nj; j += ts) carry[j] = 0.0f;
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    // stage row k and/or column k of the current array
    float* rnext = (k & 1) ? carry : rowk;   // carry_vec: the next r
    const float* rnow = (k & 1) ? rowk : carry;
    if (B == kAxis0Reduce || B == kRank1) {
      for (int j = t0; j < nj; j += ts) rowk[j] = w[k * nj + j];
    }
    if (B == kCarryVec) {
      for (int j = t0; j < nj; j += ts) rnext[j] = w[k * nj + j];
    }
    if (B == kAxis1Reduce || B == kRank1 || B == kThinTranspose) {
      for (int i = t0; i < ni; i += ts) colk[i] = w[i * nj + k];
    }
    __syncthreads();
    for (int e = t0; e < nn; e += ts) {
      const int i = e / nj, j = e % nj;
      float v;
      if (B == kAxis1Reduce) {
        v = colk[i];
      } else if (B == kAxis0Reduce) {
        v = rowk[j];
      } else if (B == kCarryVec) {
        v = rnow[j];
      } else if (B == kRank1) {
        v = __fmul_rn(colk[i], rowk[j]);
      } else {                               // thin_transpose
        v = __fmul_rn(colk[i], colk[j]);
      }
      w[e] = minus_scaled(w[e], v);
    }
    __syncthreads();
  }

  float* ok = o + blockIdx.x;
  for (int e = t0; e < nn; e += ts) ok[static_cast<size_t>(e) * s] = w[e];
}

template <int B>
int launch_wide(const float* m, float* o, int ni, int nj, int s, int n,
                cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(ni * nj + 2 * nj + ni) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_kernel<B><<<s, kThreads, smem, stream>>>(m, o, ni, nj, s, n);
  return static_cast<int>(cudaGetLastError());
}

using Launcher = void (*)(const float*, float*, int, int, int, int, int);

template <int B>
Launcher chain_of(int r) {
  switch (r) {
    case 4: return chain_kernel<B, 4>;
    case 8: return chain_kernel<B, 8>;
    case 16: return chain_kernel<B, 16>;
    case 32: return chain_kernel<B, 32>;
    default: return nullptr;
  }
}

int pow2_at_least(int v, int lo) {
  int p = lo;
  while (p < v) p *= 2;
  return p;
}

template <int B>
int launch_chains(const float* m, float* o, int ni, int nj, int s, int n,
                  cudaStream_t stream) {
  if (s == 0 || ni == 0 || nj == 0) return 0;
  const int rows = B == kAxis1Reduce ? ni : nj;
  const int len = B == kAxis1Reduce ? nj : ni;
  if (len > 32 * kMaxChainRegs) {
    return launch_wide<B>(m, o, ni, nj, s, n, stream);
  }
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  // the least g that keeps R at kMaxChainRegs, doubled while the chains
  // leave the card short of kChainFill threads an SM and a thread keeps
  // at least 4 registers
  int g = 1;
  while (g * kMaxChainRegs < len) g *= 2;
  const size_t chains = static_cast<size_t>(rows) * s;
  while (g < 32 && chains * g < static_cast<size_t>(sms) * kChainFill &&
         (len + 2 * g - 1) / (2 * g) >= 4) {
    g *= 2;
  }
  const int r = pow2_at_least((len + g - 1) / g, 4);
  const int lanes = 32 / g;
  const size_t warps = static_cast<size_t>(rows) * ((s + lanes - 1) / lanes);
  const size_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  chain_of<B>(r)<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      m, o, ni, nj, s, n, g);
  return static_cast<int>(cudaGetLastError());
}

using TileKernel = void (*)(const float*, float*, int, int, int, int);

template <int B, int RI>
TileKernel tile_of(int rj) {
  switch (rj) {
    case 1: return tile_kernel<B, RI, 1>;
    case 2: return tile_kernel<B, RI, 2>;
    case 4: return tile_kernel<B, RI, 4>;
    case 8: return tile_kernel<B, RI, 8>;
    default: return nullptr;
  }
}

template <int B>
TileKernel tile_of(int ri, int rj) {
  if (B == kThinTranspose) {         // ni = nj
    switch (ri) {
      case 1: return tile_kernel<B, 1, 1>;
      case 2: return tile_kernel<B, 2, 2>;
      case 4: return tile_kernel<B, 4, 4>;
      case 8: return tile_kernel<B, 8, 8>;
      default: return nullptr;
    }
  }
  switch (ri) {
    case 1: return tile_of<B, 1>(rj);
    case 2: return tile_of<B, 2>(rj);
    case 4: return tile_of<B, 4>(rj);
    case 8: return tile_of<B, 8>(rj);
    default: return nullptr;
  }
}

template <int B>
int launch_tile(const float* m, float* o, int ni, int nj, int s, int n,
                cudaStream_t stream) {
  if (s == 0 || ni == 0 || nj == 0) return 0;
  if (ni > kSide * kMaxTile || nj > kSide * kMaxTile) {
    return launch_wide<B>(m, o, ni, nj, s, n, stream);
  }
  const int ri = pow2_at_least((ni + kSide - 1) / kSide, 1);
  const int rj = pow2_at_least((nj + kSide - 1) / kSide, 1);
  tile_of<B>(ri, rj)<<<s, kThreads, 0, stream>>>(m, o, ni, nj, s, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m, o: (ni, nj, s) contiguous float32 on the device; body: the Body
// number above; n: the steps (ignored by negate). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int mosaic_probes_launch(int body, const float* m, float* o,
                                    int ni, int nj, int s, int n,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ni < 0 || nj < 0 || s < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (body) {
    case kNegate: return launch_flat<kNegate>(m, o, ni, nj, s, n, st);
    case kForiMask: return launch_flat<kForiMask>(m, o, ni, nj, s, n, st);
    case kDynRead: return launch_flat<kDynRead>(m, o, ni, nj, s, n, st);
    case kDynStore: return launch_flat<kDynStore>(m, o, ni, nj, s, n, st);
    case kCarryConst:
      return launch_flat<kCarryConst>(m, o, ni, nj, s, n, st);
    case kSlabAxis0: return launch_flat<kSlabAxis0>(m, o, ni, nj, s, n, st);
    case kAxis1Reduce:
      return launch_chains<kAxis1Reduce>(m, o, ni, nj, s, n, st);
    case kAxis0Reduce:
      return launch_chains<kAxis0Reduce>(m, o, ni, nj, s, n, st);
    case kCarryVec: return launch_chains<kCarryVec>(m, o, ni, nj, s, n, st);
    case kRank1: return launch_tile<kRank1>(m, o, ni, nj, s, n, st);
    case kThinTranspose:
      return launch_tile<kThinTranspose>(m, o, ni, nj, s, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
