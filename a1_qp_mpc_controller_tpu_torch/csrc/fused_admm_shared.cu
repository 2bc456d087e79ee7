// Fused fixed-iteration ADMM for shared-basis constraint matrices,
// float32: A_s = diag(e_s) (A0 + mu_s A1) diag(d_s), A0/A1 shared by the
// whole batch, minv_s the (symmetric) scaled-KKT inverse of scenario s.
//
// Replaces the TPU kernel a1_qp_mpc_controller_tpu/ops/pallas_kernels.py
// :428 fused_admm_shared (body _fused_admm_shared_kernel, :344): same
// operands, same update, all `iters` iterations inside one launch:
//   w   = rho z - y
//   rhs = sigma x - q + d (A0'(e w) + A1'(mu e w))
//   xt  = minv' rhs            (a reduction over minv's rows, compensated)
//   x   = alpha xt + (1 - alpha) x
//   ax  = e A0 (d xt) + mu e A1 (d xt)
//   zp  = alpha ax + (1 - alpha) z
//   z'  = clip(zp + y / rho, l, u)
//   y   = y + rho (zp - z')
//
// Bound on an H100 SXM: counted by the nonzeros of A0/A1 (the repository's
// friction basis kron(I_40, base/slope) has 200 and 160 of 24,000), one
// iteration is ~36 kFLOP a scenario, so at B = 1024 and 25 iterations the
// ~68 MB of operands (minv and the vectors read once, x/y/z written once)
// bound it: ~0.02 ms. Each iteration is a chain of three dependent
// phases, so what paces a block is their latency, not a rate.
//
// Design:
// - Compact shared basis. A small pack launch (pack_basis_kernel, one
//   warp a list, a ballot over 32 entries at a time) builds, on the
//   device, four groups of (index, value) nonzero lists: each column of
//   A0 and of A1 in ascending row (the A'-products), each row in
//   ascending column (the A-products). Each list goes to a fixed stride
//   (a column's at most m long, a row's at most n) with its count, and
//   its first kShort = 4 entries also to a padded copy, (0, 0) past its
//   end; no host read. When every list is within the friction basis's
//   widths (2 nonzeros in a column of A0, 4 in one of A1, 1 in a row)
//   the main kernel keeps the padded lists in shared memory (20 KB at
//   n = 120, m = 200) and sums each over that many slots, unconditional
//   fmafs; else it reads the strided lists from device memory. Any A0/A1
//   is right; density sets only the speed.
// - One block a scenario. At n <= 120 a block has 128 threads and thread
//   j keeps column j of minv in registers (the matvec's operand, padded
//   with zeros to the tier's width: 68 or 120), x_j, q_j and d_j too;
//   the rows' state, rhs and d xt sit in shared memory. Past n = 120,
//   minv sits in shared memory and a block has 256 threads.
// - Three barriers an iteration: (1) each column's A'-sums and rhs,
//   (2) the matvec and the x update, (3) each row's A-products, the z/y
//   update and the next iteration's e w and mu e w, two rows a thread
//   read before either is written, so that their loads overlap.
// - The x-update's matvec is a compensated dot product (struct Dot2) in
//   ascending row of minv. A plain fmaf chain of n = 120 terms left the
//   float64 primal residual of the 150-iteration pools 1.21-1.53x the
//   plain version's (cuBLAS) on median, and the amortized gate short of
//   its share, on an H100 80GB HBM3 at 700 W. Dot2 is as accurate as
//   the chain in twice float32's precision, rounded once. It takes ten
//   operations a term where the chain took one, but only its running
//   sum is a dependent chain, as the fmaf chain was.
// - Otherwise the dense design's arithmetic, operation for operation. The
//   A'-terms of a column are summed in ascending row (the dense loop's
//   order: its zero terms added nothing), each an fmaf chain as nvcc
//   contracted the dense loops; every elementwise
//   update is written out in __fmaf_rn / __fmul_rn with the contraction
//   nvcc chose for the dense source (read off its SASS), so that no
//   compiler choice can part the two. A row's A-product is summed over its
//   nonzeros in ascending column; with at most one nonzero in a row of A0
//   or of A1 (the repository's basis) it is the single product the
//   dense warp-shuffle tree gave. With more nonzeros in a row the order
//   differs from that tree, and so may the last bits. The padding's
//   (0, 0) terms add +0 to a sum that is never -0, which changes no bit
//   while the operands are finite.
// Arithmetic is plain IEEE float32: no TF32, no fast-math.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kPackThreads = 256;
constexpr int kRegThreads = 128;     // n <= 120: one column a thread
constexpr int kSmemThreads = 256;    // n > 120: minv in shared memory
// The padded slots a list group is read with: the friction basis's
// widths, 2 nonzeros in a column of A0, 4 in one of A1, 1 in a row.
constexpr int kColA0 = 2, kColA1 = 4, kRow = 1;
constexpr int kShort = kColA1;       // slots a list keeps padded
constexpr int kMaxSmem = 232448;     // per-block dynamic shared memory

// The pack launch's output in the scratch buffer, for the nl = 2(n + m)
// lists in the order A0's columns, A1's columns, A0's rows, A1's rows:
//   ent  4 n m (index bits, value) float2s, list k < 2n at k m, row list
//        k >= 2n at 2 n m + (k - 2n) n;
//   pad  kShort x nl float2s: slot t of list k at t nl + k, its first
//        kShort entries, then (0, 0) (slot-major, so that neighbouring
//        threads read neighbouring lists);
//   cnt  nl ints: each list's length.
struct Packed {
  float2* ent;
  float2* pad;
  int* cnt;

  __device__ Packed(void* base, int n, int m)
      : ent(static_cast<float2*>(base)),
        pad(ent + 4 * static_cast<size_t>(n) * m),
        cnt(reinterpret_cast<int*>(pad + 2 * static_cast<size_t>(n + m)
                                             * kShort)) {}
};

__device__ __forceinline__ size_t list_at(int k, int n, int m) {
  return k < 2 * n ? static_cast<size_t>(k) * m
                   : 2 * static_cast<size_t>(n) * m
                         + static_cast<size_t>(k - 2 * n) * n;
}

// Warp w of the grid builds list w: its nonzeros in ascending index, by a
// ballot over 32 entries at a time.
__global__ void __launch_bounds__(kPackThreads)
pack_basis_kernel(const float* __restrict__ a0,
                  const float* __restrict__ a1, int n, int m,
                  void* scratch) {
  const Packed out(scratch, n, m);
  const int w = (blockIdx.x * kPackThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= 2 * (n + m)) return;                 // the whole warp
  const float* a;
  int len, stride;
  if (w < 2 * n) {
    a = (w < n ? a0 : a1) + (w < n ? w : w - n);
    len = m;
    stride = n;
  } else {
    const int r = w - 2 * n;
    a = (r < m ? a0 : a1) + static_cast<size_t>(r < m ? r : r - m) * n;
    len = n;
    stride = 1;
  }
  float2* ent = out.ent + list_at(w, n, m);
  const int nl = 2 * (n + m);
  float2* pad = out.pad + w;
  int c = 0;
  for (int k0 = 0; k0 < len; k0 += 32) {
    const int k = k0 + lane;
    const float v = k < len ? __ldg(a + static_cast<size_t>(k) * stride)
                            : 0.0f;
    const unsigned nz = __ballot_sync(0xffffffffu, v != 0.0f);
    if (v != 0.0f) {
      const int at = c + __popc(nz & ((1u << lane) - 1u));
      const float2 en = make_float2(__int_as_float(k), v);
      ent[at] = en;
      if (at < kShort) pad[static_cast<size_t>(at) * nl] = en;
    }
    c += __popc(nz);
  }
  if (lane >= c && lane < kShort) {
    pad[static_cast<size_t>(lane) * nl] = make_float2(0.0f, 0.0f);
  }
  if (lane == 0) out.cnt[w] = c;
}

// A list's sum of vec[index] * value, an fmaf chain from +0 in the
// list's order. Padded: its first W slots in shared memory (W at least
// the list's length), the (0, 0) ones past its end adding exactly +0 to
// a sum that is never -0 (for finite vec). Else: the strided list in
// device memory.
template <int W>
__device__ __forceinline__ float slot_sum(const float2* s_pad, int nl, int k,
                                          const float* vec) {
  float acc = 0.0f;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const float2 en = s_pad[t * nl + k];
    acc = fmaf(vec[__float_as_int(en.x)], en.y, acc);
  }
  return acc;
}

__device__ __forceinline__ float long_sum(const Packed& pk, int k, int n,
                                          int m, const float* vec) {
  const float2* p = pk.ent + list_at(k, n, m);
  const int len = __ldg(pk.cnt + k);
  float acc = 0.0f;
  for (int t = 0; t < len; ++t) {
    const float2 en = __ldg(p + t);
    acc = fmaf(vec[__float_as_int(en.x)], en.y, acc);
  }
  return acc;
}

// A compensated dot product, Dot2 of Ogita, Rump and Oishi (2005): each
// product's rounding error taken exactly by a fused multiply-add
// (TwoProduct), each addition's by TwoSum, both errors summed beside the
// running sum and added to it once at the end. The result is as accurate
// as an ascending sum in twice the precision, then rounded. Every step is
// an explicit round-to-nearest intrinsic, so nvcc cannot re-associate or
// contract it. A (0, 0) term adds exactly +0 to both sums.
struct Dot2 {
  float p = 0.0f;   // the running sum
  float s = 0.0f;   // the summed rounding errors

  __device__ __forceinline__ void add(float a, float b) {
    const float h = __fmul_rn(a, b);
    const float r = __fmaf_rn(a, b, -h);            // a b - h, exact
    const float t = __fadd_rn(p, h);
    const float z = __fsub_rn(t, p);
    const float q = __fadd_rn(__fsub_rn(p, __fsub_rn(t, z)),
                              __fsub_rn(h, z));     // p + h - t, exact
    s = __fadd_rn(s, __fadd_rn(q, r));
    p = t;
  }

  __device__ __forceinline__ float sum() const { return __fadd_rn(p, s); }
};

// One row's z/y update from its A-products, and its next e w, mu e w.
struct Row {
  float e, y, z, rho, irho, l, u;

  __device__ __forceinline__ Row(const float* s_e, const float* s_y,
                                 const float* s_z, const float* s_rho,
                                 const float* s_irho, const float* s_l,
                                 const float* s_u, int i)
      : e(s_e[i]), y(s_y[i]), z(s_z[i]), rho(s_rho[i]), irho(s_irho[i]),
        l(s_l[i]), u(s_u[i]) {}

  __device__ __forceinline__ void update(
      float p0, float p1, float mub, float alpha, float one_minus_alpha,
      int i, float* s_y, float* s_z, float* s_ew, float* s_mew) const {
    const float me = __fmul_rn(mub, e);
    const float ax = __fmaf_rn(e, p0, __fmul_rn(me, p1));
    const float zp = __fmaf_rn(one_minus_alpha, z, __fmul_rn(alpha, ax));
    const float z1 = fminf(fmaxf(__fmaf_rn(y, irho, zp), l), u);
    const float y1 = __fmaf_rn(rho, __fsub_rn(zp, z1), y);
    s_y[i] = y1;
    s_z[i] = z1;
    const float w = __fmaf_rn(rho, z1, -y1);
    s_ew[i] = __fmul_rn(e, w);
    s_mew[i] = __fmul_rn(me, w);
  }
};

// NMAX > 0: minv's column in registers, padded to NMAX (a multiple of 4)
// with zeros; NMAX = 0: minv in shared memory.
template <int NMAX>
__global__ void __launch_bounds__(NMAX ? kRegThreads : kSmemThreads,
                                  NMAX == 0 ? 1 : NMAX > 68 ? 3 : 4)
fused_admm_shared_kernel(
    const float* __restrict__ minv, const float* __restrict__ mu,
    const float* __restrict__ d, const float* __restrict__ e,
    const float* __restrict__ q, const float* __restrict__ l,
    const float* __restrict__ u, const float* __restrict__ rho,
    const float* __restrict__ x0, const float* __restrict__ y0,
    const float* __restrict__ z0, float* __restrict__ xo,
    float* __restrict__ yo, float* __restrict__ zo, void* scratch, int n,
    int m, int rpad, int has_pad, int iters, float sigma, float alpha,
    float one_minus_alpha) {
  const int nl = 2 * (n + m);
  extern __shared__ float4 smem4[];
  float4* s_pad = smem4;                        // nl kShort/2 (has_pad)
  float* s_rhs = reinterpret_cast<float*>(smem4)
                 + (has_pad ? nl * kShort * 2 : 0);   // rpad
  float* s_minv = s_rhs + rpad;                 // n*n (NMAX = 0 only)
  float* s_xd = s_minv + (NMAX ? 0 : n * n);    // n   d * xt
  float* s_y = s_xd + n;                        // m
  float* s_z = s_y + m;                         // m
  float* s_e = s_z + m;                         // m
  float* s_l = s_e + m;                         // m
  float* s_u = s_l + m;                         // m
  float* s_rho = s_u + m;                       // m
  float* s_irho = s_rho + m;                    // m  1 / rho
  float* s_ew = s_irho + m;                     // m  e * w
  float* s_mew = s_ew + m;                      // m  mu * e * w

  const Packed pk(scratch, n, m);
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int bs = blockDim.x;
  const int j = tid;                 // this thread's column, if j < n
  const bool col = j < n;
  const float mub = mu[b];
  const size_t vn = static_cast<size_t>(b) * n;
  const size_t vm = static_cast<size_t>(b) * m;
  const float* g_minv = minv + static_cast<size_t>(b) * n * n;

  float mcol[NMAX ? NMAX : 1];
  if constexpr (NMAX > 0) {
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      mcol[i] = (i < n && col) ? g_minv[static_cast<size_t>(i) * n + j]
                               : 0.0f;
    }
  } else {
    for (int idx = tid; idx < n * n; idx += bs) s_minv[idx] = g_minv[idx];
  }
  float xj = 0.0f, qj = 0.0f, dj = 0.0f;
  if (col) {
    xj = x0[vn + j];
    qj = q[vn + j];
    dj = d[vn + j];
  }
  for (int i = tid; i < rpad; i += bs) s_rhs[i] = 0.0f;
  for (int i = tid; i < m; i += bs) {
    const float yi = y0[vm + i], zi = z0[vm + i], ei = e[vm + i];
    const float ri = rho[vm + i];
    s_y[i] = yi;
    s_z[i] = zi;
    s_e[i] = ei;
    s_l[i] = l[vm + i];
    s_u[i] = u[vm + i];
    s_rho[i] = ri;
    s_irho[i] = 1.0f / ri;
    const float w = __fmaf_rn(ri, zi, -yi);
    s_ew[i] = __fmul_rn(ei, w);
    s_mew[i] = __fmul_rn(__fmul_rn(mub, ei), w);
  }
  // The padded lists (where they fit), copied while the counts are read:
  // whether every list is within the friction basis's widths.
  if (has_pad) {
    const float4* g_pad = reinterpret_cast<const float4*>(pk.pad);
    for (int k = tid; k < nl * kShort / 2; k += bs) {
      s_pad[k] = __ldg(g_pad + k);
    }
  }
  int wide = 0;
  for (int k = tid; k < nl; k += bs) {
    const int c = __ldg(pk.cnt + k);
    wide |= c > (k < n ? kColA0 : k < 2 * n ? kColA1 : kRow);
  }
  const bool padded = !__syncthreads_or(wide) && has_pad;

  // The iterations, compiled once for each way of reading the lists, so
  // that no phase branches between its sums and their loads overlap.
  const auto iterate = [&](auto padded_tag) {
    const float2* s_slots = reinterpret_cast<const float2*>(s_pad);
    const auto sum = [&](int k, const float* vec, auto slots) {
      if constexpr (decltype(padded_tag)::value) {
        return slot_sum<decltype(slots)::value>(s_slots, nl, k, vec);
      } else {
        return long_sum(pk, k, n, m, vec);
      }
    };
    using C0 = std::integral_constant<int, kColA0>;
    using C1 = std::integral_constant<int, kColA1>;
    using R = std::integral_constant<int, kRow>;
    for (int it = 0; it < iters; ++it) {
      // (1) rhs = sigma x - q + d (A0'(e w) + A1'(mu e w)), rows ascending
      if (col) {
        const float acc0 = sum(j, s_ew, C0{});
        const float acc1 = sum(n + j, s_mew, C1{});
        s_rhs[j] = __fmaf_rn(dj, __fadd_rn(acc0, acc1),
                             __fmaf_rn(sigma, xj, -qj));
      }
      __syncthreads();
      // (2) xt = minv' rhs, rows ascending, compensated (Dot2); the x
      //     update; d xt
      if (col) {
        Dot2 dot;
        if constexpr (NMAX > 0) {
          const float4* r4 = reinterpret_cast<const float4*>(s_rhs);
#pragma unroll
          for (int i4 = 0; i4 < NMAX / 4; ++i4) {
            const float4 r = r4[i4];
            dot.add(mcol[4 * i4], r.x);
            dot.add(mcol[4 * i4 + 1], r.y);
            dot.add(mcol[4 * i4 + 2], r.z);
            dot.add(mcol[4 * i4 + 3], r.w);
          }
        } else {
          for (int i = 0; i < n; ++i) dot.add(s_minv[i * n + j], s_rhs[i]);
        }
        const float acc = dot.sum();
        xj = __fmaf_rn(alpha, acc, __fmul_rn(one_minus_alpha, xj));
        s_xd[j] = __fmul_rn(dj, acc);
      }
      __syncthreads();
      // (3) ax = e A0 (d xt) + mu e A1 (d xt), columns ascending; z, y;
      //     the next iteration's e w and mu e w. Two rows a thread at a
      //     time (the second may repeat the first), read before either is
      //     written, so that their loads overlap.
      for (int i = tid; i < m; i += 2 * bs) {
        const int i1 = i + bs < m ? i + bs : i;
        const float p0 = sum(2 * n + i, s_xd, R{});
        const float p1 = sum(2 * n + m + i, s_xd, R{});
        const float q0 = sum(2 * n + i1, s_xd, R{});
        const float q1 = sum(2 * n + m + i1, s_xd, R{});
        const Row ra(s_e, s_y, s_z, s_rho, s_irho, s_l, s_u, i);
        const Row rb(s_e, s_y, s_z, s_rho, s_irho, s_l, s_u, i1);
        ra.update(p0, p1, mub, alpha, one_minus_alpha, i, s_y, s_z, s_ew,
                  s_mew);
        if (i1 != i) {
          rb.update(q0, q1, mub, alpha, one_minus_alpha, i1, s_y, s_z, s_ew,
                    s_mew);
        }
      }
      __syncthreads();
    }
  };
  if (padded) {
    iterate(std::true_type{});
  } else {
    iterate(std::false_type{});
  }

  if (col) xo[vn + j] = xj;
  for (int i = tid; i < m; i += bs) {
    yo[vm + i] = s_y[i];
    zo[vm + i] = s_z[i];
  }
}

// The register tier's width for n (0: minv in shared memory).
int tier_of(int n) { return n <= 68 ? 68 : n <= 120 ? 120 : 0; }

// Shared memory besides the padded lists: rhs (padded to the tier's
// width), minv (tier 0), d xt and nine row vectors.
size_t fixed_bytes(int n, int m, int tier) {
  const size_t rpad = tier ? tier : (n + 3) / 4 * 4;
  return (rpad + (tier ? 0 : static_cast<size_t>(n) * n) + n
          + 9 * static_cast<size_t>(m)) * sizeof(float);
}

template <int NMAX>
int launch_main(const float* minv, const float* mu, const float* d,
                const float* e, const float* q, const float* l,
                const float* u, const float* rho, const float* x0,
                const float* y0, const float* z0, float* xo, float* yo,
                float* zo, void* scratch, int batch, int n, int m, int iters,
                float sigma, float alpha, float one_minus_alpha,
                cudaStream_t stream) {
  const size_t fixed = fixed_bytes(n, m, NMAX);
  const size_t pad = 2 * static_cast<size_t>(n + m) * kShort
                     * sizeof(float2);
  const bool has_pad = fixed + pad <= static_cast<size_t>(kMaxSmem);
  const size_t smem = fixed + (has_pad ? pad : 0);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_admm_shared_kernel<NMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rpad = NMAX ? NMAX : (n + 3) / 4 * 4;
  fused_admm_shared_kernel<NMAX>
      <<<batch, NMAX ? kRegThreads : kSmemThreads, smem, stream>>>(
          minv, mu, d, e, q, l, u, rho, x0, y0, z0, xo, yo, zo, scratch, n,
          m, rpad, has_pad, iters, sigma, alpha, one_minus_alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a0, a1: (m, n); minv: (batch, n, n); mu: (batch,); d, q, x0, xo:
// (batch, n); e, l, u, rho, y0, z0, yo, zo: (batch, m); scratch: the
// pack launch's output (struct Packed), 16-byte aligned. All
// contiguous float32 on the device. Two launches: the pack, then the
// iterations. Returns the CUDA error code of the launches.
extern "C" int fused_admm_shared_launch(
    const float* a0, const float* a1, const float* minv, const float* mu,
    const float* d, const float* e, const float* q, const float* l,
    const float* u, const float* rho, const float* x0, const float* y0,
    const float* z0, float* xo, float* yo, float* zo, void* scratch,
    int batch, int n, int m, int iters, float sigma, float alpha,
    float one_minus_alpha, void* stream) {
  if (n < 0 || m < 0 || batch < 0 || n > kSmemThreads ||
      fixed_bytes(n, m, tier_of(n)) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lists = 2 * (n + m);
  if (batch == 0 || lists == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pack_basis_kernel<<<(lists * 32 + kPackThreads - 1) / kPackThreads,
                      kPackThreads, 0, st>>>(a0, a1, n, m, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (tier_of(n)) {
#define K2_TIER(T)                                                         \
  case T:                                                                  \
    return launch_main<T>(minv, mu, d, e, q, l, u, rho, x0, y0, z0, xo, yo, \
                          zo, scratch, batch, n, m, iters, sigma, alpha,   \
                          one_minus_alpha, st);
    K2_TIER(68)
    K2_TIER(120)
    K2_TIER(0)
#undef K2_TIER
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
