"""The retired inverse variants (counterpart of ``ops/pallas_retired.py``)
that the 'schur', 'sweep_t' and 'gj_t' routes and the tests reach.

- K6a ``spd_block_inverse``: recursive Schur-complement inversion,
  products as ``torch.matmul`` and K3 (``kernels.batched_inverse_small``)
  at the base. The JAX package documents that it can lose positive
  definiteness and give NaN on the Ruiz-scaled KKT family; the port does
  what the reference does.
- K6g ``batched_inverse_T``: Gauss-Jordan in the batch-last layout
  (n, n, B), through ``csrc/inverse_t.cu``.
- K6h-k ``batched_inverse_sweep_T`` (``sym_col`` option) and its
  ``_chunked``, ``_masked`` and ``_masked2`` variants: the one-array sweep
  operator in the batch-last layout. The four TPU kernels differ only in
  how they chunk and alias VMEM, so they share one CUDA kernel
  (``csrc/inverse_t.cu``) and one plain version.

The TPU-only knobs of the JAX entry points (``sblock``, ``chunk``,
``alias``, ``block``, ``interpret``) are not carried across, nor is their
padding (n to a multiple of 8, the batch to ``sblock``: identity and
zero tails that leave the answer as it is). The transposes are kept: the
entry points take and return (B, n, n), and work batch-last inside, the
plain versions in the JAX kernels' (n, n, B) layout and the CUDA kernels
in that layout cut into tiles of 8 scenarios, (ceil(B / 8), n, n, 8). On
a CPU tensor each entry point runs its plain version; on a CUDA tensor
it launches its kernel or raises, counted in ``kernels.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops.linalg import pad_identity

_P = ctypes.c_void_p
_GJ_ARGTYPES = [_P, _P, ctypes.c_int, ctypes.c_int, _P]
_SWEEP_ARGTYPES = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]


# --- K6a: Schur-complement recursion --------------------------------------

def spd_block_inverse(m: torch.Tensor, base: int = 32) -> torch.Tensor:
    """Batched SPD inverse (B, n, n) by recursive Schur-complement block
    inversion, identity-padded to a power-of-two multiple of ``base``,
    with K3 at the base; symmetrized."""
    n = m.shape[1]
    n_pad = base
    while n_pad < n:
        n_pad *= 2
    mm = pad_identity(m, n_pad) if n_pad != n else m

    def inv(x):
        k = x.shape[1]
        if k <= base:
            return kernels.batched_inverse_small(x.contiguous())
        h = k // 2
        a, bm, c = x[:, :h, :h], x[:, :h, h:], x[:, h:, h:]
        ai = inv(a)
        w = ai @ bm
        si = inv(c - bm.transpose(1, 2) @ w)
        tr = -(w @ si)
        tl = ai - tr @ w.transpose(1, 2)
        return torch.cat([torch.cat([tl, tr], dim=2),
                          torch.cat([tr.transpose(1, 2), si], dim=2)], dim=1)

    out = inv(mm)[:, :n, :n]
    return 0.5 * (out + out.transpose(1, 2))


# --- layouts --------------------------------------------------------------

LANES = 8   # scenarios a tile of the CUDA kernels (csrc/inverse_t.cu)


def _to_batch_leading(mt: torch.Tensor) -> torch.Tensor:
    return mt.permute(2, 0, 1).contiguous()


def _to_tiles(m: torch.Tensor) -> torch.Tensor:
    """(B, n, n) -> (ceil(B / 8), n, n, 8): the kernels' layout, the
    (n, n, B) layout cut into tiles of 8 scenarios stored one after
    another (zeros pad the last tile; the kernels leave them alone)."""
    b, n, _ = m.shape
    t = -(-b // LANES)
    mp = m.new_zeros((t * LANES, n, n))
    mp[:b] = m
    return mp.view(t, LANES, n, n).permute(0, 2, 3, 1).contiguous()


def _from_tiles(x: torch.Tensor, b: int) -> torch.Tensor:
    t, n, _, lanes = x.shape
    return x.permute(0, 3, 1, 2).reshape(t * lanes, n, n)[:b].contiguous()


def _check_lanes() -> None:
    lanes = kernels._fn("inverse_t", "lanes", [])()
    if lanes != LANES:
        raise RuntimeError(f"inverse_t.cu tiles {lanes} scenarios, the "
                           f"wrappers {LANES}")


def _check_square(m: torch.Tensor) -> None:
    if m.ndim != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"expected (B, n, n), got {tuple(m.shape)}")
    kernels._check("m", m, tuple(m.shape), m.device)


# --- K6g: batch-last Gauss-Jordan -----------------------------------------

def gj_inverse_T_plain(mt: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan inverse in the (n, n, B) layout, the arithmetic of
    ``_gj_inverse_T_kernel``: pivot k zeroes its own row of the factor
    column f, updates every row as x - f[i] * (row_k * (1/d)) in M and in
    the inverse, then sets row k of both to row_k * (1/d)."""
    n, _, b = mt.shape
    m = mt.clone()
    inv = torch.eye(n, dtype=mt.dtype, device=mt.device)[:, :, None].repeat(
        1, 1, b)
    for k in range(n):
        f = m[:, k:k + 1].clone()                           # (n, 1, B)
        f[k] = 0.0
        inv_d = 1.0 / m[k:k + 1, k:k + 1]                   # (1, 1, B)
        rdm = m[k:k + 1] * inv_d
        rdi = inv[k:k + 1] * inv_d
        m = m - f * rdm
        inv = inv - f * rdi
        m[k:k + 1] = rdm
        inv[k:k + 1] = rdi
    return inv


def batched_inverse_T(m: torch.Tensor) -> torch.Tensor:
    """K6g: invert a batch of SPD matrices (B, n, n) with the batch-last
    Gauss-Jordan kernel (csrc/inverse_t.cu); its plain version, in the
    (n, n, B) layout, on the CPU."""
    _check_square(m)
    if not kernels._on_card(m):
        return _to_batch_leading(gj_inverse_T_plain(m.permute(1, 2, 0)))
    _check_lanes()
    b, n, _ = m.shape
    work = _to_tiles(m)
    inv = torch.empty_like(work)
    fn = kernels._fn("inverse_t", "gj_launch", _GJ_ARGTYPES)
    rc = fn(work.data_ptr(), inv.data_ptr(), n, b,
            torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"inverse_t_gj launch failed: CUDA error {rc}")
    kernels.launches["batched_inverse_T"] += 1
    return _from_tiles(inv, b)


# --- K6h-k: batch-last sweep ----------------------------------------------

def sweep_inverse_T_plain(mt: torch.Tensor,
                          sym_col: bool = False) -> torch.Tensor:
    """Sweep-operator inverse in the (n, n, B) layout, the arithmetic of
    ``_sweep_inverse_T_kernel`` (and its chunked and masked variants):
    pivot k with c = column k (with ``sym_col``, row k read as the
    column) and r = row k * (1/d): w - c r off the pivot row and column,
    c * (1/d) on column k, r on row k, -1/d at (k, k); the result
    negated."""
    n = mt.shape[0]
    w = mt.clone()
    jj = torch.arange(n, device=mt.device)[None, :, None]
    for k in range(n):
        rk = w[k:k + 1].clone()                             # (1, n, B)
        c = rk.transpose(0, 1) if sym_col else w[:, k:k + 1].clone()
        inv_d = 1.0 / rk[:, k:k + 1]                        # (1, 1, B)
        rd_row = rk * inv_d
        upd = w - c * rd_row
        upd[:, k:k + 1] = c * inv_d
        upd[k:k + 1] = torch.where(jj == k, -inv_d, rd_row)
        w = upd
    return -w


def batched_inverse_sweep_T(m: torch.Tensor,
                            sym_col: bool = False) -> torch.Tensor:
    """K6h: invert a batch of SPD matrices (B, n, n) with the batch-last
    sweep kernel (csrc/inverse_t.cu); ``sym_col`` reads the pivot column
    off the pivot row. Its plain version, in the (n, n, B) layout, on
    the CPU."""
    _check_square(m)
    if not kernels._on_card(m):
        return _to_batch_leading(sweep_inverse_T_plain(m.permute(1, 2, 0),
                                                       sym_col))
    _check_lanes()
    b, n, _ = m.shape
    work = _to_tiles(m)
    fn = kernels._fn("inverse_t", "sweep_launch", _SWEEP_ARGTYPES)
    rc = fn(work.data_ptr(), n, b, int(bool(sym_col)),
            torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"inverse_t_sweep launch failed: CUDA error {rc}")
    kernels.launches["batched_inverse_sweep_T"] += 1
    return _from_tiles(work, b)


def batched_inverse_sweep_T_chunked(m: torch.Tensor) -> torch.Tensor:
    """K6i, the row-chunked TPU variant: the same sweep."""
    return batched_inverse_sweep_T(m)


def batched_inverse_sweep_T_masked(m: torch.Tensor) -> torch.Tensor:
    """K6j, the row-carry TPU variant (the 'sweep_t' route): the same
    sweep."""
    return batched_inverse_sweep_T(m)


def batched_inverse_sweep_T_masked2(m: torch.Tensor) -> torch.Tensor:
    """K6k, the two-pass TPU variant: the same sweep."""
    return batched_inverse_sweep_T(m)
