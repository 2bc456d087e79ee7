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
the order and the packing, not of one rounding rule against another.
``kernel_model`` is the kernel's iterations: the x-update's matvec in
float64, rounded once (``chip_smoke.f64_xt``, which the card's
free-running check also runs), and the elementwise updates with the
plain version's roundings; its switches (another x-update model, each
update contracted into one fused multiply-add) give the earlier designs,
which ``tests/compare_amortized_gate.py orders`` runs on the amortized
gate's operands. The float64 matvec is held against float64 beside the
plain ascending float32 chain. The whole 25-iteration model
is held against the JAX kernel in interpret mode in
``tests/test_torch_kernels.py`` (its operands are built there). The
CUDA kernel itself is held against its plain version on the card
(``tests/test_torch_kernels.py``, marked ``cuda``).
"""

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.models import srb
from a1_qp_mpc_controller_tpu_torch.ops import kernels

from chip_smoke import f64_xt
from test_torch_inverses import _spd
from torch_parity import t

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


def chain_rows(minv, rhs):
    """minv' rhs as one ascending fmaf chain over minv's rows: the
    x-update of K2's first packed design."""
    xt = torch.zeros_like(rhs)
    for i in range(minv.shape[1]):
        xt = _fma(minv[:, i], rhs[:, i:i + 1], xt)
    return xt


# K2's elementwise updates, each either contracted (one fused
# multiply-add where the plain version rounds a product and a sum, as the
# earlier kernels wrote them) or separate (the plain version's roundings,
# as the kernel writes them)
UPDATES = ("w", "rhs", "x", "ax", "zp", "z1", "y1")


def _pick(on, fused, separate):
    """``fused()`` where ``on``, else ``separate()``: ``on`` a bool, or a
    (B, 1) bool tensor where rows of one batch run different variants."""
    if isinstance(on, bool):
        return fused() if on else separate()
    return torch.where(on, fused(), separate())


def kernel_model(a0, a1, minv, mu, d, e, qs, ls, us, rho_vec, x0, y0, z0,
                 *, iters, sigma=1e-6, alpha=1.6, xt=f64_xt, contracted=()):
    """The kernel's iterations in torch: the packed products in their
    order, the x-update by ``xt(minv, rhs)`` and the elementwise updates
    named in ``contracted`` (of UPDATES) as fused multiply-adds, the
    others with the plain version's roundings. The defaults are the
    kernel's arithmetic; ``xt=chain_rows, contracted=UPDATES`` is the
    earlier float32 design's. ``contracted`` may also be a dict of
    name -> (B, 1) bool tensors, so that one batch runs several variants
    (``tests/compare_amortized_gate.py orders``)."""
    on = (contracted if isinstance(contracted, dict)
          else {u: u in contracted for u in UPDATES})
    on = {u: on.get(u, False) for u in UPDATES}
    packed = Packed(a0, a1)
    me = mu[:, None] * e
    inv_rho = 1.0 / rho_vec
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    sig, alp, oma = f32(sigma), f32(alpha), f32(1.0 - alpha)
    x, y, z = x0, y0, z0
    for _ in range(iters):
        w = _pick(on["w"], lambda: _fma(rho_vec, z, -y),
                  lambda: rho_vec * z - y)
        atw = list_sums(e * w, packed.col0) + list_sums(me * w, packed.col1)
        rhs = _pick(on["rhs"], lambda: _fma(d, atw, _fma(sig, x, -qs)),
                    lambda: (sig * x - qs) + d * atw)
        xt_ = xt(minv, rhs)
        x = _pick(on["x"], lambda: _fma(alp, xt_, oma * x),
                  lambda: alp * xt_ + oma * x)
        xd = d * xt_
        p0 = list_sums(xd, packed.row0)
        p1 = list_sums(xd, packed.row1)
        ax = _pick(on["ax"], lambda: _fma(e, p0, me * p1),
                   lambda: e * p0 + me * p1)
        zp = _pick(on["zp"], lambda: _fma(oma, z, alp * ax),
                   lambda: alp * ax + oma * z)
        z1 = torch.clamp(_pick(on["z1"], lambda: _fma(y, inv_rho, zp),
                               lambda: zp + y * inv_rho), ls, us)
        y = _pick(on["y1"], lambda: _fma(rho_vec, zp - z1, y),
                  lambda: y + rho_vec * (zp - z1))
        z = z1
    return x, y, z


def _random_operands(bounds):
    """Dense random A0/A1 at (B, n, m) = (3, 30, 50) with an SPD inverse
    and a warm start; 'unclipped': bounds of 1 + |g| that no row reaches,
    'clipped': bounds 100 times tighter."""
    a0, a1 = _dense_random(50, 30, 4)
    rng = np.random.default_rng(7)
    g = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    q = g(B, 30, 30)
    minv = torch.linalg.inv(q @ q.transpose(1, 2) + 30 * torch.eye(30))
    width = 1.0 if bounds == "unclipped" else 0.01
    ls, us = -width * (1.0 + g(B, 50).abs()), width * (1.0 + g(B, 50).abs())
    return dict(a0=0.1 * a0, a1=0.1 * a1, minv=minv,
                mu=0.5 + 0.1 * g(B).abs(), d=1.0 + 0.1 * g(B, 30).abs(),
                e=1.0 + 0.1 * g(B, 50).abs(), qs=g(B, 30), ls=ls, us=us,
                rho_vec=0.1 + g(B, 50).abs(), x0=0.1 * g(B, 30),
                y0=0.01 * g(B, 50), z0=torch.zeros(B, 50))


def _scales(ops, ref, bounds):
    """Each output's scale: its largest entry; on 'unclipped', where y
    is 0 in exact arithmetic, y's is that of rho z, the term it would
    move by."""
    ls, us = ops["ls"], ops["us"]
    clipped = float(((ref[2] <= ls) | (ref[2] >= us)).float().mean())
    scale = dict(x=ref[0].abs().max(), y=ref[1].abs().max(),
                 z=ref[2].abs().max())
    if bounds == "unclipped":
        assert clipped == 0.0, clipped
        scale["y"] = (ops["rho_vec"] * ref[2]).abs().max()
    else:
        assert 0.1 <= clipped <= 0.5, clipped
    return scale


@pytest.mark.parametrize("bounds", ["unclipped", "clipped"])
def test_model_matches_plain_on_random_operands(bounds):
    """The model (the kernel's arithmetic, its defaults) against
    ``fused_admm_shared_plain`` on dense random A0/A1 at (B, n, m) =
    (3, 30, 50), 25 iterations: the same update in another summation
    order, within K2's limit (1e-4 of each output's scale). 'unclipped':
    bounds that no row reaches, so y is 0 in exact arithmetic after the
    first iteration (float64 gives 4e-18) and is held to the scale of
    rho z, the term it would move by, not to its own rounding noise.
    'clipped': 10-50% of the rows end clipped and y is held to its own
    scale."""
    ops = _random_operands(bounds)
    out = kernel_model(**ops, iters=25)
    ref = kernels.fused_admm_shared_plain(**ops, iters=25, sigma=1e-6,
                                          alpha=1.6)
    scale = _scales(ops, ref, bounds)
    for name, o, r in zip("xyz", out, ref):
        err = float((o - r).abs().max() / scale[name])
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("bounds", ["unclipped", "clipped"])
def test_contracted_updates_are_a_rounding_choice(bounds):
    """The model with every elementwise update contracted (the earlier
    kernel's fused multiply-adds) against the kernel's separate
    roundings, on the operands above: within 1e-4 of each output's
    scale, so the switch moves roundings, not the update."""
    ops = _random_operands(bounds)
    out = kernel_model(**ops, iters=25, contracted=UPDATES)
    ref = kernel_model(**ops, iters=25)
    scale = _scales(ops, ref, bounds)
    for name, o, r in zip("xyz", out, ref):
        err = float((o - r).abs().max() / scale[name])
        assert err <= 1e-4, (name, err)


def test_compensated_matvec_halves_the_chain_error():
    """On inverses of the SPD batch of the inverse tests at the KKT size
    (n = 120, B = 32) and a seeded right-hand side, the kernel's x-update
    (summed in float64, rounded once: ``chip_smoke.f64_xt``) against
    minv' rhs in float64 on the same float32 operands: over the batch,
    the median of its largest error over a scenario's largest |xt| is at
    most half the ascending float32 chain's."""
    b, n = 32, 120
    minv = torch.linalg.inv(t(_spd(b, n)).double()).float()
    rhs = torch.tensor(np.random.default_rng(8).standard_normal((b, n)),
                       dtype=torch.float32)
    ref = torch.einsum("bij,bi->bj", minv.double(), rhs.double())
    scale = ref.abs().amax(dim=1)
    err = {name: float(((fn(minv, rhs).double() - ref).abs().amax(dim=1)
                        / scale).median())
           for name, fn in (("f64", f64_xt), ("chain", chain_rows))}
    assert err["f64"] <= 0.5 * err["chain"], err


def test_shared_memory_check_only_loosened():
    """Every (n, m) the dense design took, (n^2 + 5n + 11m) floats of
    shared memory, the packed kernel takes too."""
    for n in range(1, 242, 7):
        for m in range(0, 6000, 97):
            if (n * n + 5 * n + 11 * m) * 4 <= kernels.MAX_SMEM_BYTES:
                assert kernels.fused_admm_shared_smem_bytes(n, m) \
                    <= kernels.MAX_SMEM_BYTES, (n, m)
