"""The port's SPD inverses of the 'chol', 'schur', 'sweep_t' and 'gj_t'
routes against the JAX package, on the same SPD batches (``a a'/n +
0.1 I`` from a seeded NumPy generator).

On the CPU every kernel wrapper runs its plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode. The tolerance is 1e-5 of
the reference's largest entry: the two sides sum in other orders (XLA's
reductions and dots against PyTorch's), which on these inverses
(condition number ~40) moves entries by ~1e-7 of that scale. The
``cuda``-marked tests hold each CUDA kernel against its
plain version on the card, bit for bit, and skip without one; JAX is
imported only inside the CPU tests, so they run on a machine without
JAX with ``python -m pytest --noconftest -m cuda
tests/test_torch_inverses.py``.
"""

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels, linalg
from a1_qp_mpc_controller_tpu_torch.ops import kernels_retired as retired

from torch_parity import t

REL = 1e-5


def _spd(b, n, seed=0):
    a = np.random.default_rng(seed).standard_normal((b, n, n))
    return (a @ a.transpose(0, 2, 1) / n + 0.1 * np.eye(n)).astype(np.float32)


def _close(port, ref):
    ref = np.asarray(ref)
    err = np.abs(port.numpy() - ref).max() / np.abs(ref).max()
    assert err <= REL, err


@pytest.mark.parametrize("p", [30, 12])
def test_k5_plain_matches_pallas_interpret(p):
    """K5 at the hybrid's panel and at a panel the TPU pads to 16."""
    from a1_qp_mpc_controller_tpu.ops.pallas_kernels import batched_chol_linv

    a = _spd(4, p)
    ref = batched_chol_linv(a, block=4, interpret=True)
    x = kernels.batched_chol_linv(t(a))
    _close(x, ref)
    assert torch.equal(x, torch.tril(x))


@pytest.mark.parametrize("n", [120, 50])
def test_spd_cholesky_inverse_matches_jax(n):
    """The 'chol' route's inverse at the KKT size (4 panels of 30) and at
    a size padded with an identity tail (50 -> 60)."""
    from a1_qp_mpc_controller_tpu.ops import linalg as jlinalg

    k = _spd(4, n)
    _close(linalg.spd_cholesky_inverse(t(k)), jlinalg.spd_cholesky_inverse(k))


def test_spd_cholesky_inverse_hybrid_matches_jax():
    from a1_qp_mpc_controller_tpu.ops import linalg as jlinalg

    k = _spd(4, 60)
    _close(linalg.spd_cholesky_inverse_hybrid(t(k)),
           jlinalg.spd_cholesky_inverse_hybrid(k, interpret=True))


@pytest.mark.parametrize("n", [64, 120])
def test_spd_block_inverse_matches_jax(n):
    """K6a with K3's plain version at the base (120 pads to 128)."""
    # through pallas_kernels, which loads pallas_retired and re-exports it
    from a1_qp_mpc_controller_tpu.ops.pallas_kernels import spd_block_inverse

    m = _spd(4, n)
    x = retired.spd_block_inverse(t(m))
    _close(x, spd_block_inverse(m, block=4, interpret=True))
    assert torch.equal(x, x.transpose(1, 2))


BATCH_LAST = {
    "gj_T": (retired.batched_inverse_T, "batched_inverse_T", {}),
    "sweep_T": (retired.batched_inverse_sweep_T, "batched_inverse_sweep_T",
                {}),
    "sweep_T_sym_col": (
        lambda m: retired.batched_inverse_sweep_T(m, sym_col=True),
        "batched_inverse_sweep_T", dict(sym_col=True)),
    "sweep_T_chunked": (retired.batched_inverse_sweep_T_chunked,
                        "batched_inverse_sweep_T_chunked", {}),
    "sweep_T_masked": (retired.batched_inverse_sweep_T_masked,
                       "batched_inverse_sweep_T_masked", {}),
    "sweep_T_masked2": (retired.batched_inverse_sweep_T_masked2,
                        "batched_inverse_sweep_T_masked2", {}),
}


@pytest.mark.parametrize("n", [12, 24])
@pytest.mark.parametrize("entry", sorted(BATCH_LAST))
def test_batch_last_inverses_match_jax(entry, n):
    """K6g and the four sweep entry points; B = 5 with two scenarios a
    grid step, so the JAX side pads the batch (and n = 12 to 16)."""
    from a1_qp_mpc_controller_tpu.ops import pallas_kernels

    fn, jname, jkw = BATCH_LAST[entry]
    m = _spd(5, n)
    ref = getattr(pallas_kernels, jname)(m, sblock=2, interpret=True, **jkw)
    _close(fn(t(m)), ref)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


def _counted(name, fn, *args):
    before = kernels.launches[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("p", [30, 12])
def test_k5_kernel_matches_plain_on_card(card, p):
    a = t(_spd(37, p)).to(card)
    x = _counted("batched_chol_linv", kernels.batched_chol_linv, a)
    assert torch.equal(x, kernels.batched_chol_linv_plain(a))


@pytest.mark.cuda
@pytest.mark.parametrize("b, n", [(37, 12), (37, 24), (37, 50), (37, 120),
                                  (37, 136), (1, 120), (1, 136), (133, 120)])
def test_batch_last_kernels_match_plain_on_card(card, b, n):
    """K6g and the sweep kernel (both pivot-column reads) against their
    plain versions in the (n, n, B) layout, bit for bit: every register
    tile height (n = 12, 24, 50, 120: 1, 2, 4, 8 rows), the large-n path
    (136), one matrix, and batches that are no multiple of anything (37,
    and 133, one past the SM count); the input is left as it was."""
    m = t(_spd(b, n)).to(card)
    keep = m.clone()
    mt = m.permute(1, 2, 0).contiguous()
    x = _counted("batched_inverse_T", retired.batched_inverse_T, m)
    assert torch.equal(x, retired.gj_inverse_T_plain(mt).permute(2, 0, 1))
    for sym_col in (False, True):
        x = _counted("batched_inverse_sweep_T",
                     retired.batched_inverse_sweep_T, m, sym_col)
        ref = retired.sweep_inverse_T_plain(mt, sym_col).permute(2, 0, 1)
        assert torch.equal(x, ref)
    assert torch.equal(m, keep)
