"""The port's batch-leading retired inverses K6b-K6f against the JAX
package's Pallas kernels in interpret mode, on the same NumPy inputs.

Inputs: SPD batches ``a a'/n + 0.1 I`` (condition number ~40) at n = 30,
which the rank variants pad to 32 pivots at rank 4 and 8, and one batch
of the KKT family's conditioning, ``Q diag(ev) Q'`` with eigenvalues
spread over 1e0-1e4, at the KKT size n = 120.

Tolerances, of the reference's largest entry: 1e-5 on the SPD batches;
1e-4 on the n = 120 batch. Both sides do the kernels' operations in the
same order, but XLA's CPU code fuses a multiply and a subtract into one
rounding where PyTorch rounds twice, and a condition number of 1e4
amplifies that difference (measured up to 3.4e-5 of the scale).

The ``cuda``-marked tests hold each CUDA kernel against its plain version
on the card, bit for bit, and K6f against the batch-last sweep kernel
with ``sym_col``; they skip without a card. JAX is imported only inside
the CPU tests, so they run on a machine without JAX with ``python -m
pytest --noconftest -m cuda tests/test_torch_retired.py``.
"""

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops import kernels_retired as retired

from torch_parity import t

# entry: (port function, JAX name in ops.pallas_kernels, rank or None)
ENTRIES = {
    "inplace": (retired.batched_inverse_inplace, "batched_inverse_inplace",
                None),
    "combined": (retired.batched_inverse_combined,
                 "batched_inverse_combined", None),
    "rank2": (retired.batched_inverse_rank, "batched_inverse_rank", 2),
    "rank4": (retired.batched_inverse_rank, "batched_inverse_rank", 4),
    "masked4": (retired.batched_inverse_rank_masked,
                "batched_inverse_rank_masked", 4),
    "masked8": (retired.batched_inverse_rank_masked,
                "batched_inverse_rank_masked", 8),
    "spd": (retired.batched_inverse_spd, "batched_inverse_spd", None),
}


def _spd(b, n, seed=0):
    a = np.random.default_rng(seed).standard_normal((b, n, n))
    return (a @ a.transpose(0, 2, 1) / n + 0.1 * np.eye(n)).astype(np.float32)


def _kkt_like(b, n, seed=1):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(b, n, n)))
    ev = np.exp(rng.uniform(0.0, np.log(1e4), size=(b, n)))
    return ((q * ev[:, None, :]) @ q.transpose(0, 2, 1)).astype(np.float32)


def _call(entry, m):
    fn, _, rank = ENTRIES[entry]
    return fn(m) if rank is None else fn(m, rank=rank)


def _match_jax(entry, m, rel):
    # through pallas_kernels, which loads pallas_retired and re-exports it
    from a1_qp_mpc_controller_tpu.ops import pallas_kernels

    _, jname, rank = ENTRIES[entry]
    kw = {} if rank is None else dict(rank=rank)
    ref = np.asarray(getattr(pallas_kernels, jname)(
        m, block=m.shape[0], interpret=True, **kw))
    x = _call(entry, t(m))
    assert x.shape == m.shape
    err = np.abs(x.numpy() - ref).max() / np.abs(ref).max()
    assert err <= rel, err


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_retired_inverses_match_jax_spd(entry):
    """B = 3, n = 30: the rank variants pad to 32 pivots at rank 4 and 8
    (the non-multiple case of tests/test_qp.py)."""
    _match_jax(entry, _spd(3, 30), 1e-5)


@pytest.mark.parametrize("entry", ["inplace", "combined", "rank2",
                                   "masked8", "spd"])
def test_retired_inverses_match_jax_kkt_size(entry):
    """B = 2 at the KKT size n = 120 and its conditioning: each entry
    point at the rank the JAX package defaults to."""
    _match_jax(entry, _kkt_like(2, 120), 1e-4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


PLAIN = {
    "inplace": retired.batched_inverse_inplace_plain,
    "combined": retired.batched_inverse_combined_plain,
    "rank2": lambda m: retired.batched_inverse_rank_plain(m, 2),
    "rank4": lambda m: retired.batched_inverse_rank_plain(m, 4),
    "masked4": lambda m: retired.batched_inverse_rank_masked_plain(m, 4),
    "masked8": lambda m: retired.batched_inverse_rank_masked_plain(m, 8),
    "spd": retired.batched_inverse_spd_plain,
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [30, 120])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_retired_kernels_match_plain_on_card(card, entry, n):
    """Each kernel against its plain version, bit for bit, with one
    launch counted; the input is left as it was."""
    m = t(_spd(37, n)).to(card)
    keep = m.clone()
    name = ENTRIES[entry][0].__name__
    before = kernels.launches[name]
    x = _call(entry, m)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    assert torch.equal(x, PLAIN[entry](m))
    assert torch.equal(m, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["inplace", "spd"])
def test_one_array_kernels_past_the_tile_on_card(card, entry):
    """K6b and K6f at (64, 136), past ``csrc/inverse_t.cu``'s register
    tile (its device-memory kernel), against their plain versions bit for
    bit as int32 views, so that signed zeros count."""
    m = t(_spd(64, 136)).to(card)
    x = _call(entry, m)
    torch.cuda.synchronize()
    assert torch.equal(x.view(torch.int32),
                       PLAIN[entry](m).view(torch.int32))

