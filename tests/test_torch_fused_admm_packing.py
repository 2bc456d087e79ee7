"""The arithmetic that ``csrc/fused_admm.cu`` (K4) relies on, checked on
the CPU: a torch model of its per-scenario nonzero lists and of the
products it forms from them, against a model of the dense order of the
design it replaced, bit for bit.

Each block packs its scenario's A (m, n): each row's nonzeros (column,
value) in ascending column into 2 slots, each column's (row, value) in
ascending row into 5 (the friction pyramid's widths), unused slots a
sentinel: index n (a row's) or m (a column's) of a vector whose entry
there is +0, value 0. A scenario with a longer row or column runs the
dense order instead. The dense design summed a column of A' w as an
ascending-row fmaf chain over all m rows, and a row of A xt as lane
chains (lane l: columns l, l + 32, ...) and the xor butterfly of a warp
sum; minv rhs the same way, which the kernel now takes for eight rows at
once. Each sum is an fmaf chain on the card; here ``_fma`` (an exact
float64 product and sum, then float32) stands for it on both sides, so
the comparison is of the order and the packing, not of one rounding rule
against another. The CUDA kernel itself is held against its plain
version on the card (``chip_smoke.py`` phase 3d, and the ``cuda`` tests of
``tests/test_torch_legacy.py``).
"""

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.models import srb
from a1_qp_mpc_controller_tpu_torch.ops import kernels, qp

B = 3
ROW_SLOTS, COL_SLOTS = 2, 5


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def pack(a):
    """The kernel's lists of a (B, m, n): row slots (B, m, 2) and column
    slots (B, 5, n) of (index, value), ascending, sentinels last; and
    whether each scenario overflows them (and runs the dense order)."""
    b, m, n = a.shape
    nz = a != 0
    wide = ((nz.sum(2) > ROW_SLOTS).any(1)
            | (nz.sum(1) > COL_SLOTS).any(1))
    cols = torch.arange(n).expand(b, m, n)
    key = torch.where(nz, cols, n).sort(dim=2).values[:, :, :ROW_SLOTS]
    rows_val = torch.where(key < n, a.gather(2, key.clamp(max=n - 1)), 0.0)
    rows = torch.arange(m)[:, None].expand(b, m, n)
    ckey = torch.where(nz, rows, m).sort(dim=1).values[:, :COL_SLOTS]
    cols_val = torch.where(ckey < m, a.gather(1, ckey.clamp(max=m - 1)),
                           0.0)
    return (key, rows_val), (ckey, cols_val), wide


def _pad(v):
    """The vector with its +0 sentinel entry appended."""
    return torch.cat([v, v.new_zeros((v.shape[0], 1))], dim=1)


def list_at_sums(w, col_lists):
    """A' w from the column slots: each column's fmaf chain from +0 over
    its 5 slots in order. (B, m) -> (B, n)."""
    idx, val = col_lists
    wp = _pad(w)
    acc = w.new_zeros((w.shape[0], idx.shape[2]))
    for t in range(COL_SLOTS):
        acc = _fma(val[:, t], wp.gather(1, idx[:, t]), acc)
    return acc


def list_a_sums(x, row_lists):
    """A xt from the row slots: fmaf(a2, x2, fmaf(a1, x1, 0)) where the
    two columns share a lane (j1 = j2 mod 32), else fmaf(a1, x1, 0) +
    fmaf(a2, x2, 0). (B, n) -> (B, m)."""
    idx, val = row_lists
    xp = _pad(x)
    x1, x2 = xp.gather(1, idx[:, :, 0]), xp.gather(1, idx[:, :, 1])
    zero = torch.zeros_like(x1)
    p1 = _fma(val[:, :, 0], x1, zero)
    same = ((idx[:, :, 0] ^ idx[:, :, 1]) & 31) == 0
    return torch.where(same, _fma(val[:, :, 1], x2, p1),
                       p1 + _fma(val[:, :, 1], x2, zero))


def dense_at_sums(w, a):
    """The dense design's A' w: each column's fmaf chain over every row
    in ascending order. (B, m) x (B, m, n) -> (B, n)."""
    acc = w.new_zeros((w.shape[0], a.shape[2]))
    for i in range(a.shape[1]):
        acc = _fma(a[:, i], w[:, i:i + 1], acc)
    return acc


def lane_sums(x, a):
    """The dense design's lane chains of A x: lane l sums the columns
    l, l + 32, ... in ascending order. (B, n) x (B, m, n) -> (B, m, 32)."""
    lanes = x.new_zeros((x.shape[0], a.shape[1], 32))
    for j in range(a.shape[2]):
        lanes[:, :, j % 32] = _fma(a[:, :, j], x[:, None, j],
                                   lanes[:, :, j % 32])
    return lanes


LANE = torch.arange(32)


def butterfly(lanes):
    """The xor butterfly (16, 8, 4, 2, 1) of a warp sum; lane 0's value."""
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., LANE ^ off]
    return lanes[..., 0]


def halving_butterfly(acc):
    """The kernel's sum of eight rows' lane partials (B, 8, 32) at once:
    at xor 16, 8 and 4 each lane keeps the half of its rows that its bit
    picks and adds the partner's partial sums of those rows, then xor 2
    and 1 on the one row left. Returns each lane's sum and its row
    (lane >> 2) as (B, 32), (32,)."""
    def bit(v):
        return (LANE & v) != 0

    h16, h8, h4 = bit(16), bit(8), bit(4)
    s4 = []
    for t in range(4):
        keep = torch.where(h16, acc[:, t + 4], acc[:, t])
        give = torch.where(h16, acc[:, t], acc[:, t + 4])
        s4.append(keep + give[:, LANE ^ 16])
    s2 = []
    for t in range(2):
        keep = torch.where(h8, s4[t + 2], s4[t])
        give = torch.where(h8, s4[t], s4[t + 2])
        s2.append(keep + give[:, LANE ^ 8])
    p = (torch.where(h4, s2[1], s2[0])
         + torch.where(h4, s2[0], s2[1])[:, LANE ^ 4])
    p = p + p[:, LANE ^ 2]
    p = p + p[:, LANE ^ 1]
    return p, LANE >> 2


def _friction(horizon, seed):
    """Ruiz-scaled friction pyramids (``srb.friction_constraint_matrix``)
    of B scenarios with their own mu, beside a random SPD cost."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    mu = torch.tensor(rng.uniform(0.4, 0.9, B), dtype=torch.float32)
    a = srb.friction_constraint_matrix(mu, horizon)
    m, n = a.shape[1:]
    h = g(B, n, n)
    p = h @ h.transpose(1, 2) / n + torch.eye(n)
    return qp.ruiz_equilibrate(p, g(B, n), a, -g(B, m).abs(),
                               g(B, m).abs())[2]


def _random_sparse(m, n, seed):
    """Rows of 2 nonzeros in one lane (j2 = j1 + 32) and in two, rows of
    one and empty rows; no column past 5 nonzeros."""
    rng = np.random.default_rng(seed)
    a = torch.zeros((B, m, n))
    for i in range(m):
        j1 = (3 * i) % n
        js = {0: [j1, (j1 + 32) % n], 1: [j1, (j1 + 5) % n], 2: [j1],
              3: []}[i % 4]
        for j in js:
            a[:, i, j] = torch.tensor(rng.standard_normal(B),
                                      dtype=torch.float32)
    return a


OPERANDS = {"friction-h10": lambda: _friction(10, 1),
            "friction-h3": lambda: _friction(3, 2),
            "random-sparse": lambda: _random_sparse(90, 70, 3)}


@pytest.mark.parametrize("name", list(OPERANDS))
def test_lists_keep_every_nonzero_and_only_those(name):
    """The row and the column slots each rebuild A exactly, ascending,
    with no zero value; every other slot is the sentinel; nothing
    overflows."""
    a = OPERANDS[name]()
    b, m, n = a.shape
    (ridx, rval), (cidx, cval), wide = pack(a)
    assert not bool(wide.any())
    live_r, live_c = ridx < n, cidx < m
    assert bool((rval[live_r] != 0).all()) and not bool(rval[~live_r].any())
    assert bool((cval[live_c] != 0).all()) and not bool(cval[~live_c].any())
    assert bool((ridx[:, :, 1:] >= ridx[:, :, :1]).all())
    assert bool((ridx[:, :, 1] > ridx[:, :, 0])[live_r[:, :, 1]].all())
    assert bool((cidx[:, 1:] > cidx[:, :-1])[live_c[:, 1:]].all())
    from_rows = torch.zeros((b, m, n + 1)).scatter_(2, ridx, rval)
    from_cols = torch.zeros((b, m + 1, n)).scatter_(1, cidx, cval)
    assert torch.equal(from_rows[:, :, :n], a)
    assert torch.equal(from_cols[:, :m], a)
    assert int(live_r.sum()) == int(live_c.sum()) == int((a != 0).sum())


@pytest.mark.parametrize("name", list(OPERANDS))
def test_column_sums_match_dense_order(name):
    """A' w from the column slots, bit-equal to the dense loop over every
    row in ascending order."""
    a = OPERANDS[name]()
    g = torch.Generator().manual_seed(5)
    w = torch.randn((B, a.shape[1]), generator=g)
    w[:, 7] = 0.0
    _, cols, _ = pack(a)
    assert torch.equal(list_at_sums(w, cols), dense_at_sums(w, a))


@pytest.mark.parametrize("name", list(OPERANDS))
def test_row_sums_match_dense_tree(name):
    """A xt from the row slots, bit-equal to the dense lane chains and
    butterfly, on rows with two nonzeros in one lane and in two, with one
    and with none."""
    a = OPERANDS[name]()
    g = torch.Generator().manual_seed(6)
    x = torch.randn((B, a.shape[2]), generator=g)
    rows, _, _ = pack(a)
    assert torch.equal(list_a_sums(x, rows), butterfly(lane_sums(x, a)))
    idx = rows[0][0]
    n = a.shape[2]
    two = idx[:, 1] < n
    same = ((idx[:, 0] ^ idx[:, 1]) & 31) == 0
    if name == "random-sparse":
        assert bool((two & same).any()) and bool((two & ~same).any())
        assert bool((idx[:, 0] == n).any())           # an empty row
        assert bool(((idx[:, 0] < n) & ~two).any())    # a row of one
    else:
        assert bool(two.any()) and not bool((two & same).any())


def test_overflowing_a_is_detected():
    """A scenario with a row of 3 nonzeros or a column of 6 runs the
    dense order; the others keep their lists."""
    a = _friction(3, 4)
    assert not bool(pack(a)[2].any())
    row3 = a.clone()
    row3[1, 0, 7] = 0.5                      # a third nonzero in a row
    col6 = a.clone()
    col6[2, :6, 11] = 0.25                   # a column of six
    col6[2, :6, :11] = 0.0                   # rows of at most two
    dense = torch.randn(B, *a.shape[1:],
                        generator=torch.Generator().manual_seed(7))
    assert pack(row3)[2].tolist() == [False, True, False]
    assert int((col6[2] != 0).sum(1).max()) <= ROW_SLOTS
    assert pack(col6)[2].tolist() == [False, False, True]
    assert pack(dense)[2].tolist() == [True] * B


def test_matvec_halving_matches_butterfly():
    """minv rhs: the eight rows of a warp summed at once by halving, each
    lane left with row lane >> 2, bit-equal to eight butterflies."""
    g = torch.Generator().manual_seed(8)
    minv = torch.randn((B, 8, 120), generator=g)
    rhs = torch.randn((B, 120), generator=g)
    acc = lane_sums(rhs, minv)                              # (B, 8, 32)
    p, row = halving_butterfly(acc)
    ref = butterfly(acc)                                    # (B, 8)
    assert torch.equal(p, ref[:, row])


def test_shared_memory_check_only_loosened():
    """Every (n, m) the dense design took, (n^2 + m n + 4n + 7m) floats of
    shared memory, the list kernel takes too (without its lists, which it
    drops where they do not fit)."""
    for n in range(1, 300, 3):
        for m in range(0, 8000, 37):
            if (n * n + m * n + 4 * n + 7 * m) * 4 <= kernels.MAX_SMEM_BYTES:
                assert kernels.fused_admm_smem_bytes(n, m) \
                    <= kernels.MAX_SMEM_BYTES, (n, m)
