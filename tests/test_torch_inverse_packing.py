"""The arithmetic that ``csrc/inverse_t.cu`` relies on, checked on the CPU:
a torch emulation of its pivots against the plain versions of K1 and K3
(``ops/kernels.py``), K6g, K6b, the sweep and K6f
(``ops/kernels_retired.py``), bit for bit.

The kernel keeps one array a matrix, zero-padded to 16 R (R = ceil(n / 16)
register rows a thread, 1 to 8). Gauss-Jordan keeps the live columns of
[M | I] in it: slot j holds M's column j for j > k and the inverse's
column j for j <= k, so at pivot k slot k turns over from M's column k
to the inverse's, 0 - f[i] * (1/d) off row k and, at (k, k), 1/d (K6g)
or 1 - (d - 1) * (1/d) (K1, whose factor on row k is d - 1, so that row
k takes the off-pivot rule); K6b writes slot k as (-f[i]) * (1/d), K6g's
value but for the sign of a zero. Row and column k come from the copies that
pivot k - 1 staged after its update. The CUDA kernel itself is held
against the same plain versions on the card
(``tests/test_torch_inverses.py``, marked ``cuda``, and ``chip_smoke.py``).
"""

import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops import kernels_retired as retired

from test_torch_inverses import _spd
from torch_parity import t


def _kernel_pivots(m, rule, sym_col=False):
    """The register kernel's pivots on (B, n, n) under ``rule`` ("gj",
    "k1", "sweep" or "inplace"), vectorized over the batch and the thread
    grid, in its order: the off-pivot rule on every entry (K1: with d - 1
    as row k's factor), then row k (but for K1), column k and (k, k) by
    their rules; the staged row and column k + 1 read after the
    update."""
    sweep = rule == "sweep"
    b, n, _ = m.shape
    pad = 16 * -(-n // 16)
    w = m.new_zeros((b, pad, pad))
    w[:, :n, :n] = m
    row, col = w[:, 0].clone(), w[:, :, 0].clone()
    for k in range(n):
        d = row[:, k:k + 1]                                 # (B, 1)
        inv_d = 1.0 / d
        rd = row * inv_d
        c = (row if sym_col else col).clone()
        if rule == "k1":
            c[:, k] = (d - 1.0)[:, 0]
        w = w - c[:, :, None] * rd[:, None, :]
        if rule != "k1":
            w[:, k, :] = rd
        tc = c * inv_d
        w[:, :, k] = (tc if sweep else (-c) * inv_d if rule == "inplace"
                      else 0.0 - tc)
        diag = {"gj": inv_d, "sweep": -inv_d, "inplace": inv_d,
                "k1": 1.0 - (d - 1.0) * inv_d}[rule]
        w[:, k, k] = diag[:, 0]
        if k + 1 < n:
            row, col = w[:, k + 1].clone(), w[:, :, k + 1].clone()
    out = w[:, :n, :n]
    return -out if sweep else out


def _bits(x):
    """x's bits, so that a comparison tells -0 from +0."""
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", [12, 24])
@pytest.mark.parametrize("kind", ["gj", "k1", "sweep", "sweep_sym_col",
                                  "inplace", "spd"])
def test_one_array_pivots_match_plain(kind, n):
    """Gauss-Jordan's packing with its turnover slot under K6g's, K1's and
    K6b's rules, and the sweep's per-entry rules with either pivot-column
    read, on the SPD batch of the card test (B = 37); bit for bit, signed
    zeros too. 'spd': K6f's plain version in the batch-leading layout
    against the sweep's pivots with the column read off the row, which K6f
    runs on the card."""
    m = t(_spd(37, n))
    mt = m.permute(1, 2, 0)
    if kind == "k1":
        ref = kernels.batched_inverse_plain(m)
    elif kind == "gj":
        ref = retired.gj_inverse_T_plain(mt).permute(2, 0, 1)
    elif kind == "inplace":
        ref = retired.batched_inverse_inplace_plain(m)
    elif kind == "spd":
        ref = retired.batched_inverse_spd_plain(m)
    else:
        ref = retired.sweep_inverse_T_plain(
            mt, kind == "sweep_sym_col").permute(2, 0, 1)
    rule = {"spd": "sweep", "sweep_sym_col": "sweep"}.get(kind, kind)
    x = _kernel_pivots(m, rule, kind in ("sweep_sym_col", "spd"))
    assert torch.equal(_bits(x), _bits(ref))
    if kind == "inplace":
        # on a block-diagonal batch (the KKT's structure) column k has
        # zeros, which K6b's rule signs -0 where K6g's gives +0
        h = n // 2
        m[:, :h, h:] = 0.0
        m[:, h:, :h] = 0.0
        x = _kernel_pivots(m, "inplace")
        gj = _kernel_pivots(m, "gj")
        assert torch.equal(_bits(x),
                           _bits(retired.batched_inverse_inplace_plain(m)))
        assert torch.equal(x, gj) and not torch.equal(_bits(x), _bits(gj))


@pytest.mark.parametrize("n", [32, 66])
def test_k3_pivots_match_plain(n):
    """K3 on the register kernel under K1's rules, at the Schur recursion's
    base (n = 32, R = 2, no padding) and the reduced tier's n = 66 (R = 5:
    14 zero rows and columns), on the SPD batch of the card test
    (B = 37)."""
    m = t(_spd(37, n))
    assert torch.equal(_kernel_pivots(m, "k1"),
                       kernels.batched_inverse_small_plain(m))
