"""The scripts' kernels (counterparts of the Pallas kernels in
``scripts/micro_admm.py`` and the Mosaic probe ladders
``scripts/probe_mosaic.py``, ``probe_mosaic2.py`` and ``probe_mosaic4.py``):
hand-written CUDA for Hopper, each beside a plain PyTorch version with the
same arithmetic, bound through ``ops/kernels.py``'s build.

- S1 ``micro_admm``: ``iters`` iterations of four micro-variants of the
  fused ADMM's inner loop ('full', 'nominv', 'nomatmul', 'dotgen'), N = 128
  variables, M = 256 rows, a0 shared (``csrc/micro_admm.cu``; the loop's
  unroll, 1 or 4, is a template parameter). As the TPU script's
  ``block`` shares a0 across a VMEM tile of scenarios, a block shares
  one copy of a0 in shared memory across two scenarios, each one's minv
  in registers: two is what an SM holds, so ``block`` is not a
  parameter.
- S2 ``mosaic_probe``: the probe bodies over (ni, nj, S) arrays with S
  lanes innermost (``csrc/mosaic_probes.cu``, each body as its
  dependencies allow: the per-entry bodies one elementwise pass, the
  row and column chains of axis1_reduce, axis0_reduce and carry_vec a
  few threads each, rank1 and thin_transpose on a register tile; negate
  also serves the grid negate of ``probe_mosaic4.py``, whose grid of lane
  blocks is a TPU tiling).

A wrapper takes the plain version only for a tensor that lies on the CPU;
for a CUDA tensor it launches its kernel or raises, counted in
``kernels.launches['micro_admm']`` / ``['mosaic_probes']``.
"""

from __future__ import annotations

import ctypes

import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels

_P = ctypes.c_void_p
N, M = 128, 256             # micro_admm's compile-time sizes (the script's)
ITERS = 50                  # the script's iteration count
VARIANTS = ("full", "nominv", "nomatmul", "dotgen")
UNROLLS = (1, 4)
ALPHA, SIGMA = 1.6, 1e-6    # the script's relaxation and x-regularization
# the probe bodies, numbered as in csrc/mosaic_probes.cu
BODIES = ("negate", "fori_mask", "axis1_reduce", "axis0_reduce", "dyn_read",
          "dyn_store", "carry_vec", "rank1", "thin_transpose", "carry_const",
          "slab_axis0")
# what step k indexes: rows, columns or both (checked against n)
_ROW_STEPS = ("axis0_reduce", "dyn_read", "dyn_store", "carry_vec",
              "slab_axis0", "rank1", "thin_transpose")
_COL_STEPS = ("fori_mask", "axis1_reduce", "rank1", "thin_transpose")
# the per-entry bodies, one elementwise pass whose array no shared-memory
# limit bounds; the chains and the tile take their shared-memory tier past
# 1,024 entries a chain or 128 rows or columns, so their array keeps its
# limit
_ELEMENTWISE = ("negate", "fori_mask", "dyn_read", "dyn_store",
                "carry_const", "slab_axis0")


# --- S1: the fused ADMM's micro-variants ---------------------------------

def micro_admm_plain(a0, minv, e, q, l, u, rho, x, y, z, variant="full",
                     iters=ITERS):
    """``iters`` iterations of ``variant`` (``scripts/micro_admm.py``'s
    body), batched: a0 (M, N) shared; minv (B, N, N); e, l, u, rho, y, z
    (B, M); q, x (B, N). Returns (x, y, z)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    n = q.shape[1]
    inv_rho = 1.0 / rho
    for _ in range(iters):
        ew = e * (rho * z - y)
        atw = ew[:, :n] if variant == "nomatmul" else ew @ a0
        rhs = SIGMA * x - q + atw
        if variant == "dotgen":
            xt = torch.einsum("bij,bj->bi", minv, rhs)
        elif variant == "nominv":
            xt = rhs
        else:
            xt = torch.einsum("bij,bi->bj", minv, rhs)
        x1 = ALPHA * xt + (1.0 - ALPHA) * x
        ax = torch.cat([xt, xt], dim=1) if variant == "nomatmul" else \
            xt @ a0.T
        zp = ALPHA * ax + (1.0 - ALPHA) * z
        z1 = torch.clamp(zp + y * inv_rho, l, u)
        y = y + rho * (zp - z1)
        x, z = x1, z1
    return x, y, z


def micro_admm(a0, minv, e, q, l, u, rho, x, y, z, variant="full",
               iters=ITERS, unroll=1):
    """``micro_admm_plain`` through the CUDA kernel (csrc/micro_admm.cu)
    on a CUDA tensor, N = 128 and M = 256, the iteration loop unrolled
    ``unroll`` (1 or 4) times; the plain version on the CPU."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if unroll not in UNROLLS:
        raise ValueError(f"unroll {unroll} not in {UNROLLS}")
    b = q.shape[0]
    if not kernels._on_card(q):
        return micro_admm_plain(a0, minv, e, q, l, u, rho, x, y, z,
                                variant=variant, iters=iters)
    dev = q.device
    for name, t, shape in (
            ("a0", a0, (M, N)), ("minv", minv, (b, N, N)), ("e", e, (b, M)),
            ("q", q, (b, N)), ("l", l, (b, M)), ("u", u, (b, M)),
            ("rho", rho, (b, M)), ("x", x, (b, N)), ("y", y, (b, M)),
            ("z", z, (b, M))):
        kernels._check(name, t, shape, dev)
    if a0.data_ptr() % 16:
        raise ValueError("a0: must be 16-byte aligned")
    xo, yo, zo = torch.empty_like(x), torch.empty_like(y), torch.empty_like(z)
    fn = kernels._fn("micro_admm", "launch",
                     [_P] * 13 + [ctypes.c_int] * 6 + [_P])
    rc = fn(*(t.data_ptr() for t in (a0, minv, e, q, l, u, rho, x, y, z,
                                     xo, yo, zo)),
            b, N, M, VARIANTS.index(variant), int(unroll), int(iters),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"micro_admm launch failed: CUDA error {rc}")
    kernels.launches["micro_admm"] += 1
    return xo, yo, zo


# --- S2: the Mosaic probe bodies ------------------------------------------

def _check_steps(body: str, shape, n: int) -> None:
    if body not in BODIES:
        raise ValueError(f"unknown probe body {body!r}")
    if len(shape) != 3:
        raise ValueError(f"{body}: expected (ni, nj, S), got {tuple(shape)}")
    ni, nj, _ = shape
    if n < 0 or (body in _ROW_STEPS and n > ni) or \
            (body in _COL_STEPS and n > nj):
        raise ValueError(f"{body}: {n} steps over a ({ni}, {nj}) array")
    if body == "thin_transpose" and ni != nj:
        raise ValueError(f"thin_transpose needs ni = nj, got ({ni}, {nj})")
    if body not in _ELEMENTWISE and (ni * nj + 2 * nj + ni) * 4 > \
            kernels.MAX_SMEM_BYTES:
        raise ValueError(f"{body}: a ({ni}, {nj}) array exceeds shared "
                         "memory")


def mosaic_probe_plain(body: str, m: torch.Tensor, n: int = 0
                       ) -> torch.Tensor:
    """The probe ``body``'s output for input ``m`` (ni, nj, S) after ``n``
    steps (csrc/mosaic_probes.cu lists what each computes)."""
    _check_steps(body, m.shape, n)
    if body == "negate":
        return -m
    w = m.clone()
    r = torch.zeros_like(m[:1])
    for k in range(n):
        if body == "fori_mask":
            w[:, k] = w[:, k] * 2.0
        elif body == "axis1_reduce":
            w = w - 1e-6 * w[:, k:k + 1]
        elif body == "axis0_reduce":
            w = w - 1e-6 * w[k:k + 1]
        elif body == "dyn_read":
            w[0] = m[k]
        elif body == "dyn_store":
            w[k] = m[0] * 2.0
        elif body == "carry_vec":
            r_next = w[k:k + 1]
            w = w - 1e-6 * r
            r = r_next
        elif body == "rank1":
            w = w - 1e-6 * (w[:, k:k + 1] * w[k:k + 1])
        elif body == "thin_transpose":
            c = w[:, k:k + 1]
            w = w - 1e-6 * (c * c.transpose(0, 1))
        elif body == "carry_const":
            w = w - 1e-6 * r
            r = r + 1.0
        else:                                   # slab_axis0
            w[0] = 0.0 + w[k]
    return w


def mosaic_probe(body: str, m: torch.Tensor, n: int = 0) -> torch.Tensor:
    """The probe ``body`` through its CUDA kernel (csrc/mosaic_probes.cu)
    on a CUDA tensor; the plain version on the CPU."""
    _check_steps(body, m.shape, n)
    if not kernels._on_card(m):
        return mosaic_probe_plain(body, m, n)
    kernels._check("m", m, m.shape, m.device)
    ni, nj, s = m.shape
    out = torch.empty_like(m)
    fn = kernels._fn("mosaic_probes", "launch",
                     [ctypes.c_int, _P, _P] + [ctypes.c_int] * 4 + [_P])
    rc = fn(BODIES.index(body), m.data_ptr(), out.data_ptr(), ni, nj, s,
            int(n), torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mosaic_probes launch of {body} failed: CUDA "
                           f"error {rc}")
    kernels.launches["mosaic_probes"] += 1
    return out

