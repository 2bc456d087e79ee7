"""The arithmetic that ``csrc/inverse_t.cu`` relies on, checked on the CPU:
a torch emulation of its pivots against the plain versions of K6g and the
sweep (``ops/kernels_retired.py``), bit for bit.

The kernel keeps one array a matrix, zero-padded to 16 R (R = 1, 2, 4 or
8 register rows a thread). Gauss-Jordan keeps the live columns of
[M | I] in it: slot j holds M's column j for j > k and the inverse's
column j for j <= k, so at pivot k slot k turns over from M's column k
to the inverse's, 0 - f[i] * (1/d) off row k and 1/d at (k, k). Row and
column k come from the copies that pivot k - 1 staged after its update.
The CUDA kernel itself is held against the same plain versions on the
card (``tests/test_torch_inverses.py``, marked ``cuda``).
"""

import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels_retired as retired

from test_torch_inverses import _spd
from torch_parity import t


def _kernel_pivots(m, sweep, sym_col=False):
    """The register kernel's pivots on (B, n, n), vectorized over the
    batch and the thread grid, in its order: the off-pivot rule on every
    entry, then row k, column k and (k, k) by their rules; the staged
    row and column k + 1 read after the update."""
    b, n, _ = m.shape
    pad = 16
    while pad < n:
        pad *= 2
    w = m.new_zeros((b, pad, pad))
    w[:, :n, :n] = m
    row, col = w[:, 0].clone(), w[:, :, 0].clone()
    for k in range(n):
        inv_d = 1.0 / row[:, k:k + 1]                       # (B, 1)
        rd = row * inv_d
        c = row if sym_col else col
        w = w - c[:, :, None] * rd[:, None, :]
        w[:, k, :] = rd
        tc = c * inv_d
        w[:, :, k] = tc if sweep else 0.0 - tc
        w[:, k, k] = (-inv_d if sweep else inv_d)[:, 0]
        if k + 1 < n:
            row, col = w[:, k + 1].clone(), w[:, :, k + 1].clone()
    out = w[:, :n, :n]
    return -out if sweep else out


@pytest.mark.parametrize("n", [12, 24])
@pytest.mark.parametrize("kind", ["gj", "sweep", "sweep_sym_col"])
def test_one_array_pivots_match_plain(kind, n):
    """Gauss-Jordan's packing with its turnover slot, and the sweep's
    per-entry rules with either pivot-column read, on the SPD batch of
    the card test (B = 37)."""
    m = t(_spd(37, n))
    mt = m.permute(1, 2, 0)
    if kind == "gj":
        ref = retired.gj_inverse_T_plain(mt)
    else:
        ref = retired.sweep_inverse_T_plain(mt, kind == "sweep_sym_col")
    x = _kernel_pivots(m, kind != "gj", kind == "sweep_sym_col")
    assert torch.equal(x, ref.permute(2, 0, 1))
