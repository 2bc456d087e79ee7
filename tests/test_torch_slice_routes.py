"""The reduced tier of the port's 'reduced_admm' route end to end: three
closed-loop trot ticks of ``batched_closed_loop_step`` against the JAX
package's same route (``torch_parity.trot_ticks_match``), from one
stood-up state (``torch_parity.stood_start``: B = 2, 20 stand ticks on
'gj').

At ``kkt_reduced_nr=64`` with a big bucket of 1, K3 inverts the
trotting scenarios' 22 live blocks, K2 iterates at 66 variables / 110
rows, and the bucket's scenario is solved again at full size with K1;
each tier runs its two rho-refactored rescue rounds. The route's
full-size setting (the bench's 'full' candidate) and 'reduced' run in
tests/test_torch_slice.py, the legacy route in tests/test_torch_legacy.py,
the mixed-stance big bucket in tests/test_torch_reduced.py.
"""

import numpy as np
import pytest

from a1_qp_mpc_controller_tpu_torch.ops import qp as tqp
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb

from torch_parity import count_calls, stood_start, trot_ticks_match

B = 2
# a rescue pool as large as the batch: with a smaller one, which flagged
# scenario gets a slot is decided by first-pass residuals at the float32
# rounding floor, a coin toss between two correct float32
# implementations (tests/test_torch_slice.py ranks ties instead)
RESCUE = dict(rescue_capacity=B, rescue_iters=150)
ROUTE = dict(admm_backend="pallas_shared", kkt_backend="reduced_admm",
             kkt_reduced_nr=64, kkt_big_capacity=1, **RESCUE)
KERNELS = ["batched_inverse", "batched_inverse_small", "fused_admm_shared",
           "fused_admm"]


@pytest.fixture(scope="module")
def start():
    return stood_start(B, RESCUE)


def test_reduced_tier_three_ticks_match_jax(start, monkeypatch):
    calls = count_calls(monkeypatch, KERNELS, [tb, tqp])
    reads, contacts = trot_ticks_match(start, ROUTE)
    for c in contacts:     # a trot on two legs: no tick overflows
        np.testing.assert_array_equal(c.sum(axis=1), [2] * B)
    # three host reads per tick (the overflow test and each tier's
    # straggler round); K3 on the first pass and each first rescue round,
    # K1 on the big bucket and its first rescue rounds
    assert reads == [3, 3, 3]
    assert calls["batched_inverse_small"] >= 6, calls
    assert calls["batched_inverse"] >= 6, calls
    assert calls["fused_admm_shared"] >= 12, calls
    assert calls["fused_admm"] == 0, calls
