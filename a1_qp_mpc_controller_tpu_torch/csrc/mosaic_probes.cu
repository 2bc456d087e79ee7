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
// Bound on an H100 SXM: the array read and written once over 3.35 TB/s
// (the loop bodies' 1-3 operations an entry a step are below it at S =
// 128 but for rank1 and thin_transpose at 120 x 120: ~0.010 ms of
// operations against ~0.004 ms of bytes); negate at (120, 120, 1024) moves
// 118 MB, 0.035 ms.
//
// Design: negate and fori_mask are one elementwise pass each (fori_mask's
// n steps double each column j < n once, so its result is one pass over
// the array): float4 loads and stores where m and o share their offset
// from a 16-byte boundary, a scalar head and tail, a grid of 8 blocks an
// SM by the SM count the device reports, and a grid-stride loop past it.
// The other loop bodies keep
// one lane's whole array in dynamic shared memory for all n steps (at most
// (ni nj + 2 nj + ni) floats, 58.6 KB at 120 x 120: three blocks an SM)
// and touch device memory once each way, so a block is one lane: S = 128
// lanes give 128 blocks, about one an SM. Its reads and writes of device
// memory are strided by S, 4 bytes of each 32-byte sector, but the
// neighbouring lanes' blocks read the same sectors at the same time (L2
// serves them), and it happens once a call, not once a step. Blocks of
// 32 lanes would make the accesses contiguous but leave S / 32 = 4 blocks
// for 132 SMs (measured on an H100: 16 lanes a block, 8 blocks, ran
// axis0_reduce at (120, 8, 128) in 0.62 ms, slower than its plain
// version). A step that reads row k or column k of the
// array it rewrites (axis1/axis0_reduce, carry_vec, rank1,
// thin_transpose, slab_axis0) first copies them to shared memory, then a
// barrier, the update, and a barrier before the next step. The steps
// that touch one row or column with values no other thread writes
// (dyn_read, dyn_store, carry_const) run without barriers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;      // elementwise: 2048 threads an SM
constexpr int kUnroll = 4;           // elementwise: float4s a thread a pass
constexpr int kMaxWaves = 8;         // elementwise: the grid's cap, in
                                     // resident grids

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

// The elementwise bodies over the flat array: negate (o = -m) and
// fori_mask (o = 2 m in the columns j < n, m elsewhere: its n steps double
// each of those columns once; element e lies in column (e / S) mod nj).
// The elements before the first 16-byte boundary (head) and after the
// last whole float4 (tail) go one a thread; the rest as float4s, a block
// taking kThreads U of them (U = kUnroll on large arrays, 1 on small
// ones), each thread's U loads in flight before its stores. When m and o
// sit at different offsets from a 16-byte boundary the launcher sets
// head = total: every element goes alone. row4: the four elements of
// each float4 lie in one column (S % 4 == 0, head 0).
template <int B, int U>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const float* __restrict__ m, float* __restrict__ o,
                   unsigned total, unsigned head, unsigned s, unsigned nj,
                   unsigned n, bool row4) {
  const unsigned tid = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  // fori_mask over every column or none needs no column index
  const bool all = n >= nj, none = n == 0;
  const auto scaled = [&](unsigned idx) {
    return all || (!none && idx / s % nj < n);
  };
  const auto one = [&](float v, unsigned idx) {
    if (B == kNegate) return -v;
    return scaled(idx) ? __fmul_rn(v, 2.0f) : v;
  };
  const unsigned nvec = (total - head) / 4;
  const unsigned tail = head + 4 * nvec;
  for (unsigned i = tid; i < head; i += stride) o[i] = one(m[i], i);
  for (unsigned i = tail + tid; i < total; i += stride) o[i] = one(m[i], i);
  const float4* mv = reinterpret_cast<const float4*>(m + head);
  float4* ov = reinterpret_cast<float4*>(o + head);
  for (unsigned v0 = blockIdx.x * kThreads * U + threadIdx.x; v0 < nvec;
       v0 += stride * U) {
    float4 r[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const unsigned v = v0 + k * kThreads;
      if (v < nvec) r[k] = __ldg(mv + v);
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const unsigned v = v0 + k * kThreads;
      if (v >= nvec) continue;
      const unsigned e0 = head + 4 * v;
      float4 w = r[k];
      if (B == kNegate) {
        w = make_float4(-w.x, -w.y, -w.z, -w.w);
      } else if (row4) {
        if (scaled(e0)) {
          w = make_float4(__fmul_rn(w.x, 2.0f), __fmul_rn(w.y, 2.0f),
                          __fmul_rn(w.z, 2.0f), __fmul_rn(w.w, 2.0f));
        }
      } else {
        w = make_float4(one(w.x, e0), one(w.y, e0 + 1), one(w.z, e0 + 2),
                        one(w.w, e0 + 3));
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t mo = reinterpret_cast<size_t>(m) & 15;
  size_t head = total;
  if (mo == (reinterpret_cast<size_t>(o) & 15)) {
    head = ((16 - mo) & 15) / 4;
    if (head > total) head = total;
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

__device__ __forceinline__ float minus_scaled(float w, float v) {
  return __fsub_rn(w, __fmul_rn(1e-6f, v));
}

// w (ni*nj), rowk (nj), colk (ni), carry (nj) in shared memory.
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

  float rc = 0.0f;                           // carry_const's r
  for (int k = 0; k < n; ++k) {
    if (B == kDynRead) {
      for (int j = t0; j < nj; j += ts) {
        w[j] = mk[static_cast<size_t>(k * nj + j) * s];
      }
    } else if (B == kDynStore) {
      for (int j = t0; j < nj; j += ts) {
        w[k * nj + j] = __fmul_rn(mk[static_cast<size_t>(j) * s], 2.0f);
      }
    } else if (B == kCarryConst) {
      for (int e = t0; e < nn; e += ts) w[e] = minus_scaled(w[e], rc);
      rc = __fadd_rn(rc, 1.0f);
    } else {
      // stage row k and/or column k of the current array
      float* rnext = (k & 1) ? carry : rowk;   // carry_vec: the next r
      const float* rnow = (k & 1) ? rowk : carry;
      if (B == kAxis0Reduce || B == kRank1 || B == kSlabAxis0) {
        for (int j = t0; j < nj; j += ts) rowk[j] = w[k * nj + j];
      }
      if (B == kCarryVec) {
        for (int j = t0; j < nj; j += ts) rnext[j] = w[k * nj + j];
      }
      if (B == kAxis1Reduce || B == kRank1 || B == kThinTranspose) {
        for (int i = t0; i < ni; i += ts) colk[i] = w[i * nj + k];
      }
      __syncthreads();
      if (B == kSlabAxis0) {
        for (int j = t0; j < nj; j += ts) w[j] = __fadd_rn(0.0f, rowk[j]);
      } else {
        int i = t0 / nj, j = t0 % nj;
        for (int e = t0; e < nn; e += ts) {
          float v;
          if (B == kAxis1Reduce) {
            v = colk[i];
          } else if (B == kAxis0Reduce) {
            v = rowk[j];
          } else if (B == kCarryVec) {
            v = rnow[j];
          } else if (B == kRank1) {
            v = __fmul_rn(colk[i], rowk[j]);
          } else {                           // thin_transpose
            v = __fmul_rn(colk[i], colk[j]);
          }
          w[e] = minus_scaled(w[e], v);
          j += ts;
          while (j >= nj) {
            j -= nj;
            ++i;
          }
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  float* ok = o + blockIdx.x;
  for (int e = t0; e < nn; e += ts) ok[static_cast<size_t>(e) * s] = w[e];
}

size_t probe_smem(int ni, int nj) {
  return static_cast<size_t>(ni * nj + 2 * nj + ni) * sizeof(float);
}

template <int B>
int launch_probe(const float* m, float* o, int ni, int nj, int s, int n,
                 cudaStream_t stream) {
  const size_t smem = probe_smem(ni, nj);
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (s == 0 || ni == 0 || nj == 0) return 0;
  probe_kernel<B><<<s, kThreads, smem, stream>>>(m, o, ni, nj, s, n);
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
    case kAxis1Reduce:
      return launch_probe<kAxis1Reduce>(m, o, ni, nj, s, n, st);
    case kAxis0Reduce:
      return launch_probe<kAxis0Reduce>(m, o, ni, nj, s, n, st);
    case kDynRead: return launch_probe<kDynRead>(m, o, ni, nj, s, n, st);
    case kDynStore: return launch_probe<kDynStore>(m, o, ni, nj, s, n, st);
    case kCarryVec: return launch_probe<kCarryVec>(m, o, ni, nj, s, n, st);
    case kRank1: return launch_probe<kRank1>(m, o, ni, nj, s, n, st);
    case kThinTranspose:
      return launch_probe<kThinTranspose>(m, o, ni, nj, s, n, st);
    case kCarryConst:
      return launch_probe<kCarryConst>(m, o, ni, nj, s, n, st);
    case kSlabAxis0: return launch_probe<kSlabAxis0>(m, o, ni, nj, s, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
