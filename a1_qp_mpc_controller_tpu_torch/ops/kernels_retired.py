"""The retired inverse variants (counterpart of ``ops/pallas_retired.py``):
the 'schur', 'sweep_t' and 'gj_t' routes' inverses and the batch-leading
variants that the component profile (``runtime/components.py``) times.

- K6a ``spd_block_inverse``: recursive Schur-complement inversion,
  products as ``torch.matmul`` and K3 (``kernels.batched_inverse_small``)
  at the base. The JAX package documents that it can lose positive
  definiteness and give NaN on the Ruiz-scaled KKT family; the port does
  what the reference does.
- K6g ``batched_inverse_T``: Gauss-Jordan in the batch-last layout
  (n, n, B), on the card one block a matrix with the live columns of
  [M | I] in one array (``csrc/inverse_t.cu``).
- K6h-k ``batched_inverse_sweep_T`` (``sym_col`` option) and its
  ``_chunked``, ``_masked`` and ``_masked2`` variants: the one-array sweep
  operator in the batch-last layout. The four TPU kernels differ only in
  how they chunk and alias VMEM, so they share one plain version and one
  CUDA kernel body with K6g (``csrc/inverse_t.cu``).
- K6b ``batched_inverse_inplace``: Gauss-Jordan in one working array:
  K6g's arithmetic but for the sign of column k's zeros, so K6g's kernel
  (``csrc/inverse_t.cu``) under a rule set of its own.
- K6c ``batched_inverse_combined``: Gauss-Jordan on [M | I], the pivot row
  written by a select: the arithmetic of K6g in the batch-leading layout,
  so K6g's kernel (``csrc/inverse_t.cu``) on the (B, n, n) input.
- K6d ``batched_inverse_rank`` and K6e ``batched_inverse_rank_masked``:
  rank-r panel Gauss-Jordan (``csrc/gj_rank.cu``, r = 2, 4 or 8): one
  block a matrix on a register tile with the live columns of [M | I] in
  one array for n <= 128, the shared-memory design past it (the wide
  tier). They keep the TPU versions'
  identity padding of n to a multiple of r: those pivots decide the
  panels.
- K6f ``batched_inverse_spd``: the symmetric sweep, batch-leading; the
  arithmetic of K6h with ``sym_col``, so the sweep kernel of
  ``csrc/inverse_t.cu`` with ``sym_col``. The TPU version's identity
  pivots up to 128 lanes leave the n x n block as it is, so neither
  version runs them.

K6b, K6c and K6f run ``csrc/inverse_t.cu``'s register tile for n <= 128
and its device-memory kernel past it, up to their entry points' limit.

The TPU-only knobs of the JAX entry points (``sblock``, ``chunk``,
``alias``, ``block``, ``interpret``) are not carried across, nor is their
padding (n to a multiple of 8 or to 128 lanes, the batch to ``sblock`` or
``block``: identity and zero tails that leave the answer as it is). The
batch-last entry points take and return (B, n, n); their plain versions
work in the JAX kernels' (n, n, B) layout, their CUDA kernel on (B, n, n)
as it is. On a CPU tensor each entry point runs its plain version; on a
CUDA tensor it launches its kernel or raises, counted in
``kernels.launches``.
"""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops.linalg import pad_identity


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


# --- the batch-last entry points ----------------------------------------


def _to_batch_leading(mt: torch.Tensor) -> torch.Tensor:
    return mt.permute(2, 0, 1).contiguous()


def _check_square(m: torch.Tensor) -> None:
    if m.ndim != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"expected (B, n, n), got {tuple(m.shape)}")
    kernels._check("m", m, tuple(m.shape), m.device)


def _inverse_t(m: torch.Tensor, name: str, symbol: str, plain,
               *extra: int) -> torch.Tensor:
    """The batch-last entry points: the plain version in the (n, n, B)
    layout on the CPU; on the card ``symbol`` of ``csrc/inverse_t.cu``,
    which reads (B, n, n) as it is, counted in ``launches[name]``."""
    def batch_leading(x):
        return _to_batch_leading(plain(x.permute(1, 2, 0), *extra))

    _check_square(m)
    if not kernels._on_card(m):
        return batch_leading(m)
    return kernels._inverse(m, name, "inverse_t", batch_leading,
                            kernels.T_N_MAX, symbol=symbol, extra=extra)


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
    """K6g: invert a batch of SPD matrices (B, n, n) with the Gauss-Jordan
    kernel (csrc/inverse_t.cu); its plain version, in the (n, n, B)
    layout, on the CPU."""
    return _inverse_t(m, "batched_inverse_T", "gj_launch",
                      gj_inverse_T_plain)


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
    """K6h: invert a batch of SPD matrices (B, n, n) with the sweep
    kernel (csrc/inverse_t.cu); ``sym_col`` reads the pivot column off
    the pivot row. Its plain version, in the (n, n, B) layout, on the
    CPU."""
    return _inverse_t(m, "batched_inverse_sweep_T", "sweep_launch",
                      sweep_inverse_T_plain, int(bool(sym_col)))


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


# --- K6b-K6f: batch-leading Gauss-Jordan and sweep variants ---------------

INPLACE_N_MAX = 240         # K6b / K6f: the JAX entry points' one array
RANKS = (2, 4, 8)


def batched_inverse_inplace_plain(m: torch.Tensor) -> torch.Tensor:
    """K6b's arithmetic (``_gj_inplace_kernel``): one working array w;
    pivot k with c = column k and r = row k * (1/d): w - c r off row and
    column k, r on row k, -c * (1/d) on column k, 1/d at (k, k)."""
    b, n, _ = m.shape
    w = m.clone()
    for k in range(n):
        c = w[:, :, k].clone()                              # (B, n)
        inv_d = 1.0 / w[:, k, k:k + 1]                      # (B, 1)
        rd = w[:, k, :] * inv_d
        rd[:, k] = inv_d[:, 0]
        colfix = -c * inv_d
        colfix[:, k] = inv_d[:, 0]
        c[:, k] = 0.0
        w = w - c[:, :, None] * rd[:, None, :]
        w[:, k, :] = rd
        w[:, :, k] = colfix
    return w


def batched_inverse_inplace(m: torch.Tensor) -> torch.Tensor:
    """K6b: invert a batch of SPD matrices (B, n, n) with K6g's
    Gauss-Jordan kernel under K6b's rule set (csrc/inverse_t.cu),
    n <= 240; plain version on the CPU."""
    return kernels._inverse(m, "batched_inverse_inplace", "inverse_t",
                            batched_inverse_inplace_plain, INPLACE_N_MAX,
                            symbol="inplace_launch")


def batched_inverse_combined_plain(m: torch.Tensor) -> torch.Tensor:
    """K6c's arithmetic (``_gj_combined_kernel`` on [M | I]): pivot k
    zeroes its own entry of the factor column f, every row becomes
    x - f[i] * (row_k * (1/d)), and row k becomes row_k * (1/d). That is
    K6g's arithmetic, so this is K6g's plain version in the batch-leading
    layout."""
    return _to_batch_leading(gj_inverse_T_plain(m.permute(1, 2, 0)))


def batched_inverse_combined(m: torch.Tensor) -> torch.Tensor:
    """K6c: invert a batch of SPD matrices (B, n, n) with K6g's
    Gauss-Jordan kernel (csrc/inverse_t.cu), which shares its arithmetic;
    plain version on the CPU."""
    return kernels._inverse(m, "batched_inverse_combined", "inverse_t",
                            batched_inverse_combined_plain, kernels.T_N_MAX,
                            symbol="gj_launch")


def _rank_padded(m: torch.Tensor, rank: int) -> torch.Tensor:
    """m with an identity tail up to a multiple of ``rank`` pivots."""
    if rank not in RANKS:
        raise ValueError(f"rank {rank} not in {RANKS}")
    n = m.shape[1]
    n_steps = -(-n // rank) * rank
    return pad_identity(m, n_steps) if n_steps != n else m


def _rank_plain(m: torch.Tensor, rank: int) -> torch.Tensor:
    """K6d's arithmetic (``_gj_rank_r_kernel``) on n % rank == 0."""
    b, n, _ = m.shape
    mm = m.clone()
    inv = torch.eye(n, dtype=m.dtype, device=m.device).repeat(b, 1, 1)
    for k0 in range(0, n, rank):
        panel = slice(k0, k0 + rank)
        f = mm[:, :, panel].clone()                         # (B, n, r)
        f[:, panel] = 0.0
        pm = mm[:, panel, :].clone()                        # (B, r, n)
        pi = inv[:, panel, :].clone()
        for j in range(rank):
            inv_p = 1.0 / pm[:, j:j + 1, k0 + j:k0 + j + 1]
            rm = pm[:, j:j + 1, :] * inv_p
            ri = pi[:, j:j + 1, :] * inv_p
            fac = pm[:, :, k0 + j:k0 + j + 1].clone()
            fac[:, j] = 0.0
            pm = pm - fac * rm
            pi = pi - fac * ri
            pm[:, j:j + 1] = rm
            pi[:, j:j + 1] = ri
        for j in range(rank):
            mm = mm - f[:, :, j:j + 1] * pm[:, j:j + 1, :]
            inv = inv - f[:, :, j:j + 1] * pi[:, j:j + 1, :]
        mm[:, panel] = pm
        inv[:, panel] = pi
    return inv


def _rank_masked_plain(m: torch.Tensor, rank: int) -> torch.Tensor:
    """K6e's arithmetic (``_gj_rank_masked_kernel``) on n % rank == 0."""
    b, n, _ = m.shape
    mm = m.clone()
    inv = torch.eye(n, dtype=m.dtype, device=m.device).repeat(b, 1, 1)
    for k0 in range(0, n, rank):
        rows_m, rows_i, cols = [], [], []
        for j in range(rank):
            kj = k0 + j
            rm, ri = mm[:, kj, :], inv[:, kj, :]            # (B, n) raw
            cj = mm[:, :, kj]
            for l in range(j):
                e = rm[:, k0 + l:k0 + l + 1]
                rm = rm - e * rows_m[l]
                ri = ri - e * rows_i[l]
            d = rm[:, kj:kj + 1]
            inv_d = 1.0 / d
            rm = rm * inv_d
            ri = ri * inv_d
            for l in range(j):
                cj = cj - cols[l] * rows_m[l][:, kj:kj + 1]
            cj = cj.clone()
            cj[:, kj] = d[:, 0] - 1.0
            rows_m.append(rm)
            rows_i.append(ri)
            cols.append(cj)
        for j in range(rank):
            mm = mm - cols[j][:, :, None] * rows_m[j][:, None, :]
            inv = inv - cols[j][:, :, None] * rows_i[j][:, None, :]
    return inv


def batched_inverse_rank_plain(m: torch.Tensor, rank: int = 2
                               ) -> torch.Tensor:
    """K6d's plain version on (B, n, n), n padded to a multiple of
    ``rank`` and cut back."""
    n = m.shape[1]
    return _rank_plain(_rank_padded(m, rank), rank)[:, :n, :n]


def batched_inverse_rank_masked_plain(m: torch.Tensor, rank: int = 8
                                      ) -> torch.Tensor:
    """K6e's plain version on (B, n, n), n padded to a multiple of
    ``rank`` and cut back."""
    n = m.shape[1]
    return _rank_masked_plain(_rank_padded(m, rank), rank)[:, :n, :n]


def _rank_n_max(rank: int) -> int:
    """The largest multiple of ``rank`` whose arrays on the wide tier
    (2n^2 + 3 rank n floats) fit in a block's shared memory."""
    n = rank
    while (2 * (n + rank) ** 2 + 3 * rank * (n + rank)) * 4 \
            <= kernels.MAX_SMEM_BYTES:
        n += rank
    return n


def _rank_inverse(m, rank, name, symbol, plain):
    n = m.shape[1]
    mm = _rank_padded(m, rank).contiguous()
    out = kernels._inverse(mm, name, "gj_rank", lambda x: plain(x, rank),
                           _rank_n_max(rank), symbol=symbol, extra=(rank,))
    return out if mm is m else out[:, :n, :n].contiguous()


def batched_inverse_rank(m: torch.Tensor, rank: int = 2) -> torch.Tensor:
    """K6d: invert a batch of SPD matrices (B, n, n) with the rank-r panel
    Gauss-Jordan kernel (csrc/gj_rank.cu: the register tile for n <= 128,
    then the wide tier), r in (2, 4, 8); plain version on the CPU."""
    return _rank_inverse(m, rank, "batched_inverse_rank", "launch",
                         _rank_plain)


def batched_inverse_rank_masked(m: torch.Tensor, rank: int = 8
                                ) -> torch.Tensor:
    """K6e: invert a batch of SPD matrices (B, n, n) with the corrected
    rank-r panel Gauss-Jordan kernel (csrc/gj_rank.cu: the register tile
    for n <= 128, then the wide tier), r in (2, 4, 8); plain version on
    the CPU."""
    return _rank_inverse(m, rank, "batched_inverse_rank_masked",
                         "masked_launch", _rank_masked_plain)


def rank_reg_occupancy(n: int, rank: int, masked: bool) -> dict:
    """The register-tier kernel of csrc/gj_rank.cu that n (<= 128), rank
    and ``masked`` select: its resident blocks (matrices) an SM by CUDA's
    occupancy calculator, its registers and its local memory (spill)
    bytes a thread."""
    return kernels.occupancy("gj_rank", "occupancy", n, rank, int(masked))


def batched_inverse_spd_plain(m: torch.Tensor) -> torch.Tensor:
    """K6f's arithmetic (``_sweep_inverse_kernel``): the sweep with the
    pivot row read as the column, negated at the end; that is K6h's plain
    version with ``sym_col``, in the batch-leading layout."""
    return _to_batch_leading(sweep_inverse_T_plain(m.permute(1, 2, 0),
                                                   sym_col=True))


def batched_inverse_spd(m: torch.Tensor) -> torch.Tensor:
    """K6f: invert a batch of SPD matrices (B, n, n) with the sweep kernel
    of csrc/inverse_t.cu, the pivot column read off the pivot row
    (``sym_col``), n <= 240; plain version on the CPU."""
    return kernels._inverse(m, "batched_inverse_spd", "inverse_t",
                            batched_inverse_spd_plain, INPLACE_N_MAX,
                            symbol="sweep_launch", extra=(1,))
