"""The arithmetic that ``csrc/fused_admm_shared.cu`` (K2) relies on,
checked on the CPU: a torch model of its packed shared basis and of the
products it forms from it, against the dense sums of the design it
replaced, bit for bit.

The kernel's pack launch writes, for each column of A0 and of A1, its
nonzeros (row, value) in ascending row, and for each row its nonzeros
(column, value) in ascending column: each list at a fixed stride with its
count, and its first four entries padded with (0, 0); when every list
fits the friction basis's widths (2, 4, 1 and 1 slots for A0's and A1's
columns and rows) the main kernel reads that many padded slots from
shared memory, else the strided lists from device memory. The A'-products sum a
column's terms in ascending row, as the dense loop did over all m rows
(its zero terms, and the padding's, add nothing); a row's A-product
sums its nonzeros in ascending column, which equals the dense design's
lane sums and warp-shuffle tree wherever a row of A0 or A1 has at most
one nonzero (the repository's basis). Each sum is
an fmaf chain on the card; here ``_fma`` (an exact float64 product and
sum, then float32) stands for it on both sides, so the comparison is of
the order and the packing, not of one rounding rule against another. The
whole 25-iteration model is held against the JAX kernel in interpret mode
in ``tests/test_torch_kernels.py`` (its operands are built there). The
CUDA kernel itself is held against its plain version on the card
(``tests/test_torch_kernels.py``, marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.models import srb
from a1_qp_mpc_controller_tpu_torch.ops import kernels

B = 3


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


SHORT = 4      # kShort: lists this long are kept padded in shared memory


def list_at(k, n, m):
    """Where list k starts in the strided layout."""
    return k * m if k < 2 * n else 2 * n * m + (k - 2 * n) * n


def pack(a0, a1):
    """The pack launch's output (``struct Packed``), for the 2 (n + m)
    lists in the order A0's columns, A1's columns, A0's rows, A1's rows:
    ``ent`` (4 n m, 2) of (index, value) at the strides of ``list_at``,
    ``pad`` (2 (n + m), SHORT, 2) each list's first SHORT entries then
    (0, 0), ``cnt`` each list's length."""
    m, n = a0.shape
    ent = torch.zeros((4 * n * m, 2))
    pad = torch.zeros((2 * (n + m), SHORT, 2))
    cnt = torch.zeros(2 * (n + m), dtype=torch.int64)
    lines = ([a[:, j] for a in (a0, a1) for j in range(n)]
             + [a[i] for a in (a0, a1) for i in range(m)])
    for k, line in enumerate(lines):
        idx = torch.nonzero(line != 0).flatten()
        seg = torch.stack([idx.float(), line[idx]], dim=1)
        at = list_at(k, n, m)
        ent[at:at + len(idx)] = seg
        pad[k, :min(len(idx), SHORT)] = seg[:SHORT]
        cnt[k] = len(idx)
    return ent, pad, cnt


# the padded slots the kernel reads a group of lists with (``Narrow``):
# A0's and A1's columns, A0's and A1's rows of the friction basis
NARROW = (2, SHORT, 1, 1)


def lists_of(a0, a1):
    """Each list as the main kernel reads it: the first NARROW slots of
    each group when every list fits them, else each list from the
    strided layout by its count; (K, L) index, value and validity tensors
    per group, ready for ``list_sums`` (a padded (0, 0) slot counts as an
    entry)."""
    m, n = a0.shape
    ent, pad, cnt = pack(a0, a1)
    spans = ((0, n), (n, n), (2 * n, m), (2 * n + m, m))
    widths = None
    if all(int(cnt[lo:lo + k].max()) <= w
           for (lo, k), w in zip(spans, NARROW)):
        widths = NARROW
    segs = []
    for g, (lo, count) in enumerate(spans):
        for k in range(lo, lo + count):
            at = list_at(k, n, m)
            segs.append(pad[k, :widths[g]] if widths
                        else ent[at:at + int(cnt[k])])
    groups = []
    for lo, count in spans:
        width = max([1] + [len(segs[k]) for k in range(lo, lo + count)])
        idx = torch.zeros((count, width), dtype=torch.int64)
        val = torch.zeros((count, width))
        ok = torch.zeros((count, width), dtype=torch.bool)
        for r in range(count):
            seg = segs[lo + r]
            idx[r, :len(seg)] = seg[:, 0].long()
            val[r, :len(seg)] = seg[:, 1]
            ok[r, :len(seg)] = True
        groups.append((idx, val, ok))
    return groups


def list_sums(vec, lists):
    """Each list's sum of vec[:, index] * value, an fmaf chain from +0 in
    its order (padded entries included): (B, K)."""
    idx, val, ok = lists
    acc = vec.new_zeros((vec.shape[0], idx.shape[0]))
    for t in range(idx.shape[1]):
        term = _fma(vec[:, idx[:, t]], val[:, t], acc)
        acc = torch.where(ok[:, t], term, acc)
    return acc


class Packed:
    """The four list groups of a packed basis, as the kernel reads them."""

    def __init__(self, a0, a1):
        self.col0, self.col1, self.row0, self.row1 = lists_of(a0, a1)


def dense_at_sums(w, a):
    """The dense design's A'-product: for each column, every row's term
    in ascending row (B, m) x (m, n) -> (B, n)."""
    acc = w.new_zeros((w.shape[0], a.shape[1]))
    for i in range(a.shape[0]):
        acc = _fma(w[:, i:i + 1], a[i], acc)
    return acc


def dense_a_sums(x, a):
    """The dense design's A-product: lane l of a warp sums the columns
    l, l + 32, ... in ascending order, then the warp-shuffle tree (xor
    16, 8, 4, 2, 1) adds the lanes; lane 0's value. (B, n) -> (B, m)."""
    m, n = a.shape
    lanes = x.new_zeros((x.shape[0], m, 32))
    for j in range(n):
        lanes[:, :, j % 32] = _fma(a[:, j], x[:, None, j],
                                   lanes[:, :, j % 32])
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, lane ^ off]
    return lanes[:, :, 0]


def _basis(n_blk):
    return srb.friction_constraint_basis_nblk(n_blk, torch.float32, "cpu")


def _dense_random(m, n, seed):
    rng = np.random.default_rng(seed)
    a0, a1 = (torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32)
              for _ in range(2))
    a1[:, 1] = 0.0                  # an all-zero column
    a0[3] = 0.0                     # an all-zero row
    return a0, a1


def _wide_basis(n_blk):
    """The friction basis with a second nonzero in the fifth row of each
    block of A0 (at its x column): every list at most 4 long, but not
    within the basis's widths, so the kernel reads the strided lists."""
    a0, a1 = _basis(n_blk)
    a0[4::5, 0::3] += 0.5 * torch.eye(n_blk)
    return a0, a1


BASES = {"basis-40": lambda: _basis(40), "basis-22": lambda: _basis(22),
         "wide-10": lambda: _wide_basis(10),
         "dense-50x30": lambda: _dense_random(50, 30, 3)}


@pytest.mark.parametrize("name", list(BASES))
def test_packing_keeps_every_nonzero_and_only_those(name):
    """The strided lists rebuild A0 and A1 exactly, each in ascending
    index with no zero; the padded ones hold each list's first SHORT
    entries, then (0, 0)."""
    a0, a1 = BASES[name]()
    m, n = a0.shape
    ent, pad, cnt = pack(a0, a1)
    assert int(cnt.sum()) == 2 * int((a0 != 0).sum() + (a1 != 0).sum())
    rebuilt = torch.zeros((4, m, n))
    for k in range(2 * (n + m)):
        seg = ent[list_at(k, n, m):list_at(k, n, m) + int(cnt[k])]
        pos = seg[:, 0].long()
        assert bool((pos[1:] > pos[:-1]).all())         # ascending
        assert bool((seg[:, 1] != 0).all())
        short = min(len(seg), SHORT)
        assert torch.equal(pad[k, :short], seg[:short])
        assert not bool(pad[k, short:].any())
        if k < 2 * n:
            rebuilt[k // n, pos, k % n] = seg[:, 1]
        else:
            r = k - 2 * n
            rebuilt[2 + r // m, r % m, pos] = seg[:, 1]
    for g, a in enumerate((a0, a1, a0, a1)):
        assert torch.equal(rebuilt[g], a)
    if name.startswith("wide"):
        assert int(cnt[2 * n:2 * n + m].max()) == 2 <= int(cnt.max()) <= SHORT
        assert lists_of(a0, a1)[2][0].shape[1] == 2   # strided, not 1 slot
    if name.startswith("basis"):
        # A1's fifth row of each block and its x and y columns are zero
        assert int(cnt[2 * n + m + 4]) == 0 and int(cnt[n]) == 0
        assert int(cnt[:n].max()) <= 2 and int(cnt[n:2 * n].max()) == 4
        assert int(cnt[2 * n:].max()) == 1          # one nonzero a row
        # every list within its group's padded slots
        assert [g[0].shape[1] for g in lists_of(a0, a1)] == list(NARROW)
    if name.startswith("dense"):
        assert int(cnt.max()) > SHORT               # the strided lists


@pytest.mark.parametrize("name", list(BASES))
def test_at_products_match_dense_sums(name):
    """A0'(e w) and A1'(mu e w) from the column lists, bit-equal to the
    dense loop over every row in ascending order."""
    a0, a1 = BASES[name]()
    packed = Packed(a0, a1)
    g = torch.Generator().manual_seed(5)
    w = torch.randn((B, a0.shape[0]), generator=g)
    w[:, 7] = 0.0
    assert torch.equal(list_sums(w, packed.col0), dense_at_sums(w, a0))
    assert torch.equal(list_sums(w, packed.col1), dense_at_sums(w, a1))


@pytest.mark.parametrize("name", ["basis-40", "basis-22"])
def test_a_products_match_dense_tree(name):
    """A0 (d xt) and A1 (d xt) from the row lists, bit-equal to the dense
    lane sums and shuffle tree, on the repository's basis."""
    a0, a1 = BASES[name]()
    packed = Packed(a0, a1)
    g = torch.Generator().manual_seed(6)
    x = torch.randn((B, a0.shape[1]), generator=g)
    assert torch.equal(list_sums(x, packed.row0), dense_a_sums(x, a0))
    assert torch.equal(list_sums(x, packed.row1), dense_a_sums(x, a1))


def kernel_model(a0, a1, minv, mu, d, e, qs, ls, us, rho_vec, x0, y0, z0,
                 *, iters, sigma=1e-6, alpha=1.6):
    """The kernel's iterations in torch: the packed products in their
    order, the matvec an ascending chain over minv's rows; the
    elementwise updates as in the plain version."""
    packed = Packed(a0, a1)
    me = mu[:, None] * e
    inv_rho = 1.0 / rho_vec
    x, y, z = x0, y0, z0
    for _ in range(iters):
        w = rho_vec * z - y
        atw = list_sums(e * w, packed.col0) + list_sums(me * w, packed.col1)
        rhs = sigma * x - qs + d * atw
        xt = torch.zeros_like(x)
        for i in range(minv.shape[1]):
            xt = _fma(minv[:, i], rhs[:, i:i + 1], xt)
        x = alpha * xt + (1.0 - alpha) * x
        xd = d * xt
        ax = e * list_sums(xd, packed.row0) + me * list_sums(xd, packed.row1)
        zp = alpha * ax + (1.0 - alpha) * z
        z1 = torch.clamp(zp + y * inv_rho, ls, us)
        y = y + rho_vec * (zp - z1)
        z = z1
    return x, y, z


def test_model_matches_plain_on_random_operands():
    """The model against ``fused_admm_shared_plain`` on dense random
    A0/A1 at (B, n, m) = (3, 30, 50), 25 iterations: the same update in
    another summation order, within K2's limit (1e-4 of each output's
    scale)."""
    a0, a1 = _dense_random(50, 30, 4)
    rng = np.random.default_rng(7)
    g = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    q = g(B, 30, 30)
    minv = torch.linalg.inv(q @ q.transpose(1, 2) + 30 * torch.eye(30))
    ls, us = -1.0 - g(B, 50).abs(), 1.0 + g(B, 50).abs()
    ops = dict(a0=0.1 * a0, a1=0.1 * a1, minv=minv,
               mu=0.5 + 0.1 * g(B).abs(), d=1.0 + 0.1 * g(B, 30).abs(),
               e=1.0 + 0.1 * g(B, 50).abs(), qs=g(B, 30), ls=ls, us=us,
               rho_vec=0.1 + g(B, 50).abs(), x0=0.1 * g(B, 30),
               y0=0.01 * g(B, 50), z0=torch.zeros(B, 50))
    out = kernel_model(**ops, iters=25)
    ref = kernels.fused_admm_shared_plain(**ops, iters=25, sigma=1e-6,
                                          alpha=1.6)
    for name, o, r in zip("xyz", out, ref):
        err = float((o - r).abs().max() / r.abs().max())
        assert err <= 1e-4, (name, err)


def test_shared_memory_check_only_loosened():
    """Every (n, m) the dense design took, (n^2 + 5n + 11m) floats of
    shared memory, the packed kernel takes too."""
    for n in range(1, 242, 7):
        for m in range(0, 6000, 97):
            if (n * n + 5 * n + 11 * m) * 4 <= kernels.MAX_SMEM_BYTES:
                assert kernels.fused_admm_shared_smem_bytes(n, m) \
                    <= kernels.MAX_SMEM_BYTES, (n, m)
