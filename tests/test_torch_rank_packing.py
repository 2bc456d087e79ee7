"""The arithmetic that ``csrc/gj_rank.cu``'s register tier relies on,
checked on the CPU: a torch emulation of its one-array rank-r panels
against the plain versions of K6d and K6e (``_rank_plain``,
``_rank_masked_plain`` in ``ops/kernels_retired.py``), bit for bit.

The kernel keeps one array a matrix, zero-padded to 16 R (R = 2, 4 or 8).
Before panel [k0, k0 + r) slot c holds the inverse's column c for c < k0
and M's column c for c >= k0; the panel's r slots turn over from M's
columns to the inverse's, which start as unit columns. A panel stages
its raw rows (a slab over every slot) and M's raw panel columns, one
warp eliminates the r x r block where they meet (K6d: the factors and
1/d of each pivot; K6e: the corrections e_jl, d_j, 1/d_j and the block's
scaled rows), a thread a slot carries the slab through the pivots, a
thread a row corrects the column block (K6e), and every entry then takes
x - f[i][q] * row_q[c] for q = 0 .. r-1 in order. The emulation below
does the same steps on the whole padded batch at once. The CUDA kernel
itself is held against the same plain versions on the card
(``tests/test_torch_retired.py``, marked ``cuda``, and ``chip_smoke.py``).
"""

import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels_retired as retired

from test_torch_inverses import _spd
from torch_parity import t


def _block(s, k0, rank, masked):
    """The warp's r x r block of M (rows and columns k0 .. k0+r-1 of the
    raw slab ``s``, (B, r, P)): K6d's factors fac[j][q] (column j of the
    block before pivot j) and 1/d_j; K6e's e[j][l], d_j, 1/d_j and the
    scaled rows' block entries rows[j][q]."""
    b = s.shape[0]
    blk = s[:, :, k0:k0 + rank].clone()                      # [j][q]
    coef = dict(inv=s.new_zeros((b, rank)), e=s.new_zeros((b, rank, rank)),
                d=s.new_zeros((b, rank)), rows=s.new_zeros((b, rank, rank)))
    for j in range(rank):
        if not masked:
            inv_p = 1.0 / blk[:, j, j:j + 1]
            coef["e"][:, j] = blk[:, :, j]
            rm = blk[:, j] * inv_p
            for r in range(rank):
                if r != j:
                    blk[:, r] = blk[:, r] - coef["e"][:, j, r:r + 1] * rm
            blk[:, j] = rm
            coef["inv"][:, j] = inv_p[:, 0]
            continue
        v = blk[:, j].clone()
        for l in range(j):
            e = v[:, l:l + 1].clone()
            coef["e"][:, j, l] = e[:, 0]
            v = v - e * coef["rows"][:, l]
        d = v[:, j:j + 1]
        inv_d = 1.0 / d
        coef["rows"][:, j] = v * inv_d
        coef["d"][:, j], coef["inv"][:, j] = d[:, 0], inv_d[:, 0]
    return coef


def _slab(s, k0, rank, masked, coef):
    """Each slot's column of the panel rows through the pivots: the
    turnover slots from the inverse's unit columns."""
    v = s.clone()
    v[:, :, k0:k0 + rank] = torch.eye(rank)
    for j in range(rank):
        inv = coef["inv"][:, j:j + 1]
        if not masked:
            rm = v[:, j] * inv
            for r in range(rank):
                if r != j:
                    v[:, r] = v[:, r] - coef["e"][:, j, r:r + 1] * rm
            v[:, j] = rm
            continue
        x = v[:, j]
        for l in range(j):
            x = x - coef["e"][:, j, l:l + 1] * v[:, l]
        v[:, j] = x * inv
    return v


def _columns(f, k0, rank, coef):
    """K6e: each row's corrected panel columns, d_j - 1 on the pivot
    rows."""
    c = f.clone()
    for j in range(rank):
        x = f[:, j]
        for l in range(j):
            x = x - c[:, l] * coef["rows"][:, l, j:j + 1]
        x = x.clone()
        x[:, k0 + j] = coef["d"][:, j] - 1.0
        c[:, j] = x
    return c


def _tile_panels(m, rank, masked):
    """The register tier's panels on (B, n, n), n a multiple of rank."""
    b, n, _ = m.shape
    pad = 16 * next(r for r in (2, 4, 8) if n <= 16 * r)
    w = m.new_zeros((b, pad, pad))
    w[:, :n, :n] = m
    for k0 in range(0, n, rank):
        panel = slice(k0, k0 + rank)
        s = w[:, panel, :].clone()                           # (B, r, P)
        f = w[:, :, panel].transpose(1, 2).clone()           # (B, r, P)
        coef = _block(s, k0, rank, masked)
        s = _slab(s, k0, rank, masked, coef)
        if masked:
            f = _columns(f, k0, rank, coef)
        w[:, :, panel] = (torch.eye(pad)[:, panel] if masked else 0.0)
        for j in range(rank):
            w = w - f[:, j, :, None] * s[:, j, None, :]
        if not masked:
            w[:, panel, :] = s
    return w[:, :n, :n]


@pytest.mark.parametrize("n", [30, 120])
@pytest.mark.parametrize("rank", [2, 4, 8])
@pytest.mark.parametrize("masked", [False, True], ids=["K6d", "K6e"])
def test_one_array_panels_match_plain(masked, rank, n):
    """K6d's and K6e's panels on the register tier's one array, on the
    SPD batch of the card test (B = 8; n = 30 padded to a multiple of r
    with identity pivots, as the wrapper pads it)."""
    m = retired._rank_padded(t(_spd(8, n)), rank)
    plain = retired._rank_masked_plain if masked else retired._rank_plain
    assert torch.equal(_tile_panels(m, rank, masked), plain(m, rank))
