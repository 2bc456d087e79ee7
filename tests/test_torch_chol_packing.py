"""The arithmetic that ``csrc/chol_linv.cu``'s register tier relies on,
checked on the CPU: a torch emulation of its lane layout against K5's
plain version (``ops/kernels.batched_chol_linv_plain``), bit for bit.

The tier runs one warp a panel for p <= 32, its rows unrolled to P = 8,
16 or 32. Lane j holds column j of the panel in registers (rows past p
and lanes past p load zeros) as a window: at step k, w[t] is row k + t,
and the window moves up a row a step. Cholesky step k takes a_kk and the
column-k entries a_ik (i > k) from lane k by shuffles (all of them first)
and a_kj from the lane's own w[0]; lanes j > k take a_ij - (a_ik a_kj) /
a_kk, the others divide zero; lane k pushes sqrt(a_kk) and lanes j > k
push a_kj / sqrt(a_kk) onto their column of L' (lt, shifted a place a
step and P - p places after the last, so that lt[r] = L'[r][j]). A
zero dividend gives the zero (or the divisor's NaN), IEEE's quotient
since each divisor is clamped to >= 1e-30 (``div_clamped``: the kernel
divides 1 in its place and drops the quotient). Substitution step k has lane k broadcast L'[r][k]
(r < k) and L'[k][k], and every lane sum its M[r][j] over r = 0..k-1 in
order. The emulation below does the same on the whole batch at once: a
(B, P, 32) tensor is the registers of a warp, a shuffle from lane k is
a gather of its column, a step or row past p is skipped as the kernel's
guards skip it. The CUDA kernel itself is held against the same plain
version on the card by the ``cuda`` cases (both tiers: p <= 32 in
registers, 33 and 64 in shared memory) and by ``chip_smoke.py``.
"""

import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels

from test_torch_inverses import _spd
from torch_parity import t

LANES = 32
TINY = 1e-30
# the hybrid's panel (30), the tiers' edges and one past each
CPU_PS = (1, 7, 8, 30, 32)
CARD_PS = CPU_PS + (31, 33, 64)


def tier(p: int) -> int:
    """The register tier's P for p (csrc/chol_linv.cu ``reg_kernel``)."""
    return 8 if p <= 8 else 16 if p <= 16 else 32


def div_clamped(x, y):
    return torch.where(x == 0, torch.where(y == y, x, y), x / y)


def shift(v):
    """Each lane's registers up a place, a zero in the last."""
    return torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)


def lane_model(a: torch.Tensor, big_p: int) -> torch.Tensor:
    """K5's register tier on (B, p, p) float32 panels, P = ``big_p``."""
    b, p, _ = a.shape
    lane = torch.arange(LANES)
    w = a.new_zeros((b, big_p, LANES))
    w[:, :p, :p] = a
    lt, m = torch.zeros_like(w), torch.zeros_like(w)
    zero = torch.zeros_like(w[:, 0])
    for k in range(p):
        akk = torch.clamp(w[:, 0, k], min=TINY)[:, None]       # shuffle
        sq = torch.sqrt(akk)
        akj = w[:, 0].clone()
        col = w[:, :, k].clone()                               # shuffles
        for t in range(1, big_p):
            if k + t >= p:
                break
            num = torch.where(lane > k, col[:, t:t + 1] * akj, zero)
            upd = w[:, t] - div_clamped(num, akk)
            w[:, t] = torch.where(lane > k, upd, w[:, t])
        lkj = div_clamped(torch.where(lane > k, akj, zero), sq)
        lt, w = shift(lt), shift(w)
        lt[:, -1] = torch.where(lane == k, sq, lkj)
    for _ in range(p, big_p):
        lt = shift(lt)
    for k in range(p):
        acc = torch.zeros_like(zero)
        for r in range(k):
            acc = acc + lt[:, r, k][:, None] * m[:, r]        # shuffle
        lkk = torch.clamp(lt[:, k, k], min=TINY)[:, None]      # shuffle
        m[:, k] = div_clamped((lane == k).to(a.dtype) - acc, lkk)
    return m[:, :p, :p]


def _skewed(a, skew, gen):
    """``a`` plus ``skew`` times an antisymmetric part: not symmetric, as
    the blocked trailing updates leave a panel, with the symmetric part
    (so every pivot) still positive."""
    r = torch.randn(a.shape, generator=gen, device=a.device)
    return a + skew * (r - r.transpose(1, 2))


def _panel(p, seed=0, skew=0.0):
    """Seeded SPD panels (B = 5), ``skew`` as in :func:`_skewed`."""
    a = t(_spd(5, p, seed))
    return _skewed(a, skew, torch.Generator().manual_seed(seed + 1))


@pytest.mark.parametrize("skew", [0.0, 1e-3])
@pytest.mark.parametrize("p", CPU_PS)
def test_lane_model_matches_plain(p, skew):
    """The lane layout at its own tier and at the widest (P = 32: the
    guards on steps and rows past p) is K5's plain arithmetic."""
    a = _panel(p, skew=skew)
    ref = kernels.batched_chol_linv_plain(a)
    for big_p in {tier(p), 32}:
        assert torch.equal(lane_model(a, big_p), ref), (p, big_p)


def test_lane_model_reads_rows_and_columns_as_given():
    """A panel that is not symmetric: the lane layout takes row k from
    each lane's own register and column k from lane k, as the plain
    version reads them; transposing the panel changes the answer."""
    a = _panel(30, seed=3, skew=0.05)
    x = lane_model(a, 32)
    assert torch.isfinite(x).all()
    assert torch.equal(x, kernels.batched_chol_linv_plain(a))
    assert not torch.equal(x, lane_model(a.transpose(1, 2).contiguous(), 32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [0.0, 1e-3])
@pytest.mark.parametrize("p", CARD_PS)
def test_k5_tiers_match_plain_on_card(card, p, skew):
    """Both tiers of the kernel against the plain version, bit for bit,
    on a batch that fills no block (37 panels, 4 a block), launch
    counted; the input is left as it was."""
    a = t(_spd(37, p)).to(card)
    a = _skewed(a, skew, torch.Generator(device=card).manual_seed(1))
    keep = a.clone()
    before = kernels.launches["batched_chol_linv"]
    x = kernels.batched_chol_linv(a)
    torch.cuda.synchronize()
    assert kernels.launches["batched_chol_linv"] == before + 1
    assert torch.equal(x, kernels.batched_chol_linv_plain(a))
    assert torch.equal(a, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [8, 16, 30, 32, 64])
def test_k5_tiers_do_not_spill(card, p):
    occ = kernels.chol_linv_occupancy(p)
    assert occ["local_bytes"] == 0 and occ["blocks"] > 0, occ
