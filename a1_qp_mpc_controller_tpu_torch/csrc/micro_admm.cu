// Micro-variants of the fused ADMM's inner loop, float32.
//
// Replaces the TPU kernel scripts/micro_admm.py:102 run (body make_kernel
// :39), which times four variants of K2's iteration on TPU tiles. Per
// scenario b, with a0 (M, N) shared and m = minv[b] (N, N), `iters` times:
//   w   = rho z - y
//   atw = (e w) a0             ('full', 'nominv', 'dotgen')
//         (e w)[:N]            ('nomatmul')
//   rhs = 1e-6 x - q + atw
//   xt  = minv' rhs            ('full', 'nomatmul': sum_i m[i, j] rhs[i])
//         minv rhs             ('dotgen': sum_j m[i, j] rhs[j]; the random
//                               minv is not symmetric, so the two differ)
//         rhs                  ('nominv')
//   x   = 1.6 xt + (1 - 1.6) x
//   ax  = a0 xt                ('full', 'nominv', 'dotgen')
//         [xt, xt]             ('nomatmul')
//   zp  = 1.6 ax + (1 - 1.6) z
//   z   = clip(zp + y (1 / rho), l, u)
//   y   = y + rho (zp - z)
// The clip keeps a NaN as jnp.clip does ('nominv' diverges at the script's
// inputs: a timing-only variant).
//
// Bound on an H100 SXM at B = 1024, 50 iterations: 'full' and 'dotgen' do
// ~168k operations an iteration a scenario (two M x N products, an N x N
// matvec, the elementwise updates): 8.6 GFLOP, ~0.128 ms at 67 TFLOP/s
// (float32 outside the tensor cores), against ~78 MB read and written once
// (~0.023 ms), so operations bound them.
//
// What an SM can hold decides the design: a0 is 128 KB and each
// scenario's minv 64 KB, against 256 KB of registers and 227 KB of shared
// memory. The TPU script shares a0 across a tile of scenarios; here a
// block of 512 threads runs kS = 2 scenarios on one copy of a0 in shared
// memory (rows padded to N + 4 floats, 132 KB), and keeps each scenario's
// minv in registers, 64 floats a thread (at most 128 registers a thread,
// one block an SM: B = 1024 is 512 blocks, ~3.9 waves). Each a0 entry
// read from shared memory feeds one fused multiply-add for each
// scenario.
// - The M-vectors (y, z and the row data) live in registers, one (s, m)
//   row a thread: the lane where the a0 xt product's reduction ends.
// - (e w) a0: warp w takes the 8 columns 8w..8w+7 and lane l the rows
//   l + 32r (r < 8), both scenarios: 16 partial sums of 8 rows each
//   (fmaf chains in r), then folded across the 32 lanes by shuffles
//   (lane pairs l, l ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1). Lanes 2u and 2u + 1
//   end with output u = 8s + c: the N-vectors x and q of (s, 8w + c) live
//   there, and rhs is formed in place.
// - minv' rhs ('full'; minv rhs for 'dotgen'): thread j of scenario s's
//   eight warps holds minv's column j (row j) in two halves of 64 entries
//   on lanes l and l ^ 16; each sums its half (an fmaf chain over rhs,
//   read as broadcast float4s) and one shuffle adds the halves, half 0
//   first: the partition of the previous design, so xt is unchanged.
// - a0 xt: half-warp h of warp w takes the rows 16w + 8h .. +7, lane j
//   the columns 4j..4j+3 and 64+4j..64+4j+3, both scenarios: 16 partial
//   sums of 8 columns each, folded across the 16 lanes of the half
//   (j, j ^ 8, then ^ 4, ^ 2, ^ 1); lane j ends with row 8s + r's output,
//   which is that lane's own M-vector row.
// Three barriers an iteration (after e w, rhs and xt are staged in shared
// memory; 'nominv' has no xt stage), where the previous design had five.
// Every shared-memory access is conflict-free or a broadcast. The loop's
// unroll is the template parameter U; every product is an explicit fmaf
// chain or fold and every update an __f*_rn intrinsic, so the unrolls of
// one variant agree bit for bit. Plain IEEE float32, no tensor cores.
// tests/test_torch_scripts.py models this partition of each product in
// torch.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 128;
constexpr int kM = 256;
constexpr int kS = 2;                    // scenarios a block
constexpr int kThreads = kS * kM;        // 512: one (s, m) row a thread
constexpr int kWarps = kThreads / 32;    // 16
constexpr int kWarpsPerS = kWarps / kS;  // 8: minv's warps a scenario
constexpr int kLdA = kN + 4;             // a0's padded row stride
constexpr int kHalf = kN / 2;            // minv entries a thread
constexpr int kLdV = kN + 4;             // an N-vector's padded stride
constexpr int kRowsAtw = kM / 32;        // 8: a0 rows a lane, (e w) a0
constexpr int kColsAtw = kN / kWarps;    // 8: a0 columns a warp, (e w) a0
constexpr int kRowsAx = kM / kWarps / 2; // 8: a0 rows a half-warp, a0 xt

enum Variant { kFull = 0, kNoMinv = 1, kNoMatmul = 2, kDotgen = 3 };

__host__ __device__ constexpr int a0_floats(int v) {
  return v == kNoMatmul ? 0 : kM * kLdA;
}
constexpr int kVecFloats = kS * kM + 2 * kS * kLdV;   // ew, rhs, xt

// Entry i of a staged N-vector: its second half 4 floats on, so that the
// two halves' broadcast reads fall on different banks.
__device__ __forceinline__ int vec_at(int i) {
  return i + (i / kHalf) * 4;
}

// kVals values a lane -> kVals / 2: each lane keeps the half that
// (lane & kMask) picks and adds the partner's (lane ^ kMask) copy of it.
template <int kVals, int kMask>
__device__ __forceinline__ void fold(float* v, int lane) {
  const bool up = (lane & kMask) != 0;
#pragma unroll
  for (int i = 0; i < kVals / 2; ++i) {
    const float keep = up ? v[kVals / 2 + i] : v[i];
    const float send = up ? v[i] : v[kVals / 2 + i];
    v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, kMask));
  }
}

template <int V, int U>
__global__ void __launch_bounds__(kThreads, 1)
micro_admm_kernel(const float* __restrict__ a0,
                  const float* __restrict__ minv,
                  const float* __restrict__ e, const float* __restrict__ q,
                  const float* __restrict__ l, const float* __restrict__ u,
                  const float* __restrict__ rho,
                  const float* __restrict__ x0, const float* __restrict__ y0,
                  const float* __restrict__ z0, float* __restrict__ xo,
                  float* __restrict__ yo, float* __restrict__ zo, int batch,
                  int iters) {
  extern __shared__ float4 smem4[];
  float* s_a0 = reinterpret_cast<float*>(smem4);   // kM x kLdA
  float* s_ew = s_a0 + a0_floats(V);               // kS x kM
  float* s_rhs = s_ew + kS * kM;                   // kS x kLdV
  float* s_xt = s_rhs + kS * kLdV;                 // kS x kLdV

  const int t = threadIdx.x;
  const int w = t / 32;
  const int lane = t % 32;
  const int b0 = kS * blockIdx.x;
  // the M-vector row (s, m) this thread owns: where a0 xt's fold ends
  const int jl = lane % 16;
  const int s_m = jl / 8;
  const int m_own = 2 * kRowsAx * w + kRowsAx * (lane / 16) + jl % 8;
  // the N-vector entry (s, n) on lanes 2u, 2u + 1: where (e w) a0's ends
  const int un = lane / 2;
  const int s_n = un / kColsAtw;
  const int n_own = kColsAtw * w + un % kColsAtw;
  // minv's column (or row) j, half h, of scenario s_v
  const int s_v = w / kWarpsPerS;
  const int j_v = 16 * (w % kWarpsPerS) + jl;
  const int h_v = lane / 16;

  if (V != kNoMatmul) {
    for (int idx = t; idx < kM * kN / 4; idx += kThreads) {
      const int r = idx / (kN / 4), c = 4 * (idx % (kN / 4));
      *reinterpret_cast<float4*>(s_a0 + r * kLdA + c) =
          reinterpret_cast<const float4*>(a0)[idx];
    }
  }
  float mv[V == kNoMinv ? 1 : kHalf];
  if (V != kNoMinv) {
    const bool ok = b0 + s_v < batch;
    const float* mb = minv + static_cast<size_t>(b0 + s_v) * kN * kN;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int k = kHalf * h_v + i;
      mv[i] = !ok             ? 0.0f
              : V == kDotgen ? mb[j_v * kN + k]
                             : mb[k * kN + j_v];
    }
  }
  const bool ok_m = b0 + s_m < batch;
  const size_t vm = static_cast<size_t>(b0 + s_m) * kM + m_own;
  const float e_t = ok_m ? e[vm] : 0.0f, l_t = ok_m ? l[vm] : 0.0f;
  const float u_t = ok_m ? u[vm] : 0.0f, rho_t = ok_m ? rho[vm] : 1.0f;
  const float irho = __fdiv_rn(1.0f, rho_t);
  float y = ok_m ? y0[vm] : 0.0f, z = ok_m ? z0[vm] : 0.0f;
  const bool ok_n = b0 + s_n < batch;
  const size_t vn = static_cast<size_t>(b0 + s_n) * kN + n_own;
  float x = ok_n ? x0[vn] : 0.0f;
  const float q_t = ok_n ? q[vn] : 0.0f;
  s_ew[s_m * kM + m_own] = __fmul_rn(e_t, __fsub_rn(__fmul_rn(rho_t, z), y));
  __syncthreads();

#pragma unroll (U)
  for (int it = 0; it < iters; ++it) {
    float atw;
    if (V != kNoMatmul) {      // (e w) a0, columns 8w..8w+7
      float acc[kS * kColsAtw];
#pragma unroll
      for (int i = 0; i < kS * kColsAtw; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int r = 0; r < kRowsAtw; ++r) {
        const int row = lane + 32 * r;
        const float4* ar = reinterpret_cast<const float4*>(
            s_a0 + row * kLdA + kColsAtw * w);
        const float4 lo = ar[0], hi = ar[1];
        const float a[kColsAtw] = {lo.x, lo.y, lo.z, lo.w,
                                   hi.x, hi.y, hi.z, hi.w};
        const float ew0 = s_ew[row], ew1 = s_ew[kM + row];
#pragma unroll
        for (int c = 0; c < kColsAtw; ++c) {
          acc[c] = fmaf(ew0, a[c], acc[c]);
          acc[kColsAtw + c] = fmaf(ew1, a[c], acc[kColsAtw + c]);
        }
      }
      fold<16, 16>(acc, lane);
      fold<8, 8>(acc, lane);
      fold<4, 4>(acc, lane);
      fold<2, 2>(acc, lane);
      atw = __fadd_rn(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], 1));
    } else {
      atw = s_ew[s_n * kM + n_own];
    }
    if (lane % 2 == 0) {
      s_rhs[s_n * kLdV + vec_at(n_own)] =
          __fadd_rn(__fsub_rn(__fmul_rn(1e-6f, x), q_t), atw);
    }
    __syncthreads();
    const float* s_x = s_rhs;  // xt ('nominv': rhs)
    if (V != kNoMinv) {        // half h_v of xt[j_v]'s sum
      const float* r = s_rhs + s_v * kLdV + (kHalf + 4) * h_v;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kHalf; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(r + i);
        acc = fmaf(mv[i], r4.x, acc);
        acc = fmaf(mv[i + 1], r4.y, acc);
        acc = fmaf(mv[i + 2], r4.z, acc);
        acc = fmaf(mv[i + 3], r4.w, acc);
      }
      const float other = __shfl_xor_sync(0xffffffffu, acc, 16);
      if (h_v == 0) s_xt[s_v * kLdV + vec_at(j_v)] = __fadd_rn(acc, other);
      __syncthreads();
      s_x = s_xt;
    }
    x = __fadd_rn(__fmul_rn(1.6f, s_x[s_n * kLdV + vec_at(n_own)]),
                  __fmul_rn(-0.6f, x));
    float ax;
    if (V != kNoMatmul) {      // a0 xt, rows 16w + 8h .. +7
      float acc[kS * kRowsAx];
#pragma unroll
      for (int i = 0; i < kS * kRowsAx; ++i) acc[i] = 0.0f;
      const float* arow = s_a0 + (m_own - jl % 8) * kLdA;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int c = kHalf * g + 4 * jl;
        const float4 x0v = *reinterpret_cast<const float4*>(s_x + vec_at(c));
        const float4 x1v =
            *reinterpret_cast<const float4*>(s_x + kLdV + vec_at(c));
#pragma unroll
        for (int r = 0; r < kRowsAx; ++r) {
          const float4 a =
              *reinterpret_cast<const float4*>(arow + r * kLdA + c);
          float& p0 = acc[r];
          float& p1 = acc[kRowsAx + r];
          p0 = fmaf(a.x, x0v.x, p0);
          p0 = fmaf(a.y, x0v.y, p0);
          p0 = fmaf(a.z, x0v.z, p0);
          p0 = fmaf(a.w, x0v.w, p0);
          p1 = fmaf(a.x, x1v.x, p1);
          p1 = fmaf(a.y, x1v.y, p1);
          p1 = fmaf(a.z, x1v.z, p1);
          p1 = fmaf(a.w, x1v.w, p1);
        }
      }
      fold<16, 8>(acc, lane);
      fold<8, 4>(acc, lane);
      fold<4, 2>(acc, lane);
      fold<2, 1>(acc, lane);
      ax = acc[0];
    } else {
      ax = s_x[s_m * kLdV + vec_at(m_own % kN)];
    }
    const float zp = __fadd_rn(__fmul_rn(1.6f, ax), __fmul_rn(-0.6f, z));
    float z1 = __fadd_rn(zp, __fmul_rn(y, irho));
    z1 = z1 < l_t ? l_t : z1;  // a NaN stays NaN, as in jnp.clip
    z1 = z1 > u_t ? u_t : z1;
    y = __fadd_rn(y, __fmul_rn(rho_t, __fsub_rn(zp, z1)));
    z = z1;
    s_ew[s_m * kM + m_own] =
        __fmul_rn(e_t, __fsub_rn(__fmul_rn(rho_t, z), y));
    __syncthreads();
  }

  if (ok_m) {
    yo[vm] = y;
    zo[vm] = z;
  }
  if (ok_n && lane % 2 == 0) xo[vn] = x;
}

template <int V, int U>
int launch(const float* a0, const float* minv, const float* e,
           const float* q, const float* l, const float* u, const float* rho,
           const float* x0, const float* y0, const float* z0, float* xo,
           float* yo, float* zo, int batch, int iters, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(a0_floats(V) + kVecFloats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      micro_admm_kernel<V, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  micro_admm_kernel<V, U><<<(batch + kS - 1) / kS, kThreads, smem, stream>>>(
      a0, minv, e, q, l, u, rho, x0, y0, z0, xo, yo, zo, batch, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a0: (M, N); minv: (batch, N, N); e, l, u, rho, y0, z0, yo, zo:
// (batch, M); q, x0, xo: (batch, N); contiguous float32 on the device,
// a0 16-byte aligned, N = 128, M = 256. variant: 0 'full', 1 'nominv', 2
// 'nomatmul', 3 'dotgen'; unroll 1 or 4. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int micro_admm_launch(const float* a0, const float* minv,
                                 const float* e, const float* q,
                                 const float* l, const float* u,
                                 const float* rho, const float* x0,
                                 const float* y0, const float* z0, float* xo,
                                 float* yo, float* zo, int batch, int n,
                                 int m, int variant, int unroll, int iters,
                                 void* stream) {
  if (n != kN || m != kM || iters < 0 ||
      reinterpret_cast<size_t>(a0) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MICRO_ADMM_CASE(V, U)                                             \
  if (variant == V && unroll == U) {                                      \
    return launch<V, U>(a0, minv, e, q, l, u, rho, x0, y0, z0, xo, yo, zo, \
                        batch, iters, s);                                  \
  }
  MICRO_ADMM_CASE(kFull, 1)
  MICRO_ADMM_CASE(kFull, 4)
  MICRO_ADMM_CASE(kNoMinv, 1)
  MICRO_ADMM_CASE(kNoMinv, 4)
  MICRO_ADMM_CASE(kNoMatmul, 1)
  MICRO_ADMM_CASE(kNoMatmul, 4)
  MICRO_ADMM_CASE(kDotgen, 1)
  MICRO_ADMM_CASE(kDotgen, 4)
#undef MICRO_ADMM_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
