"""The slice end to end: three closed-loop ticks of the port's
``batched_closed_loop_step`` against the JAX package's, on the 'gj',
'amortized', 'reduced' and 'full' solver routes, from identical state;
and the top-k order both packages rank by.

The state is a B = 2 ``make_flat_batch`` stood up for 20 ticks by the JAX
package (its Pallas kernels in interpret mode), then handed to both. The
three ticks are the first of the trot (0.3 m/s): contacts flip and the
post-flip rescue window opens. With a refresh capacity of 1 the
amortized route runs its refresh-all branch (flips overflow the
capacity), then refresh-some with tied ages, the accuracy continuation
and the rho-refactored rescue. On 'reduced' (a big bucket of 1) the
KKT inverse is the contact-pattern-reduced one: K3 on one trotting
scenario's live block, K1 on the other at full size. 'full' is the
bench's second candidate ('reduced_admm' at ``kkt_reduced_nr=128``): the
full-size solve with two rho-refactored rescue rounds.

Tolerances are those of the batched-vs-single gate in
tests/test_parallel.py: torques 5e-3, forces 0.05 N (float32 noise of
two schedules over a few warm-carried ticks); every discrete decision
(contacts, cooldown counters, refresh ages) must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu.config import load_profile as jload
from a1_qp_mpc_controller_tpu.parallel import batched as jb
from a1_qp_mpc_controller_tpu.types import JoyCmd as JJoy
from a1_qp_mpc_controller_tpu_torch import config as tcfg
from a1_qp_mpc_controller_tpu_torch import convert, tensors
from a1_qp_mpc_controller_tpu_torch import types as tt
from a1_qp_mpc_controller_tpu_torch.ops import qp as tqp
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb
from a1_qp_mpc_controller_tpu_torch.sim.closed_loop import LoopCarry
from a1_qp_mpc_controller_tpu_torch.sim.terrain import Terrain

from torch_parity import (
    CPU, SCHEDULE, assert_close, count_calls, jax_to_dict, to_port,
)

B = 2
RESCUE = dict(rescue_capacity=1, rescue_iters=150)
AMORTIZED = dict(kkt_amortize_capacity=1, kkt_refine_order=3)
# the tick's keyword arguments on the routes that need more than RESCUE
ROUTE_KW = {"reduced": dict(kkt_backend="reduced", kkt_reduced_nr=64,
                            kkt_big_capacity=1),
            "full": dict(kkt_backend="reduced_admm", kkt_reduced_nr=128,
                         kkt_big_capacity=160)}


@pytest.fixture(scope="module")
def start():
    cfg, params = jload("gazebo_mpc")
    cfg = dataclasses.replace(cfg, **SCHEDULE)
    # under one jit: run eagerly, its small vmapped ops cost ~10 s
    pb, terr, carry = jax.jit(lambda key: jb.make_flat_batch(
        cfg, key, B, params))(jax.random.PRNGKey(0))
    dt = jnp.float32(cfg.control_dt)
    kw = dict(admm_backend="pallas_shared", kkt_block=B, admm_block=B,
              interpret=True, return_stats=True, **RESCUE)
    gj = jax.jit(lambda c, joy: jb.batched_closed_loop_step(
        cfg, pb, terr, c, joy, dt, kkt_backend="gj", **kw))
    amortized = jax.jit(lambda c, k, joy: jb.batched_closed_loop_step(
        cfg, pb, terr, c, joy, dt, kkt_backend="amortized", kkt_carry=k,
        **AMORTIZED, **kw))
    routes = {
        name: jax.jit(lambda c, joy, rkw=rkw: jb.batched_closed_loop_step(
            cfg, pb, terr, c, joy, dt, **rkw, **kw))
        for name, rkw in ROUTE_KW.items()}
    for _ in range(20):
        carry, _ = gj(carry, JJoy.zeros())
    trot = JJoy.zeros().replace(ctrl_state=jnp.int32(1),
                                velx=jnp.float32(0.3))
    tcfg_, _ = tcfg.load_profile("gazebo_mpc", device=CPU)
    return dict(
        cfg=cfg, carry=carry, trot=trot, gj=gj, amortized=amortized,
        **routes,
        tcfg=dataclasses.replace(tcfg_, **SCHEDULE),
        pb=to_port(tcfg.RobotParams, pb), terr=to_port(Terrain, terr),
        joy=tt.JoyCmd.zeros(device=CPU).replace(
            ctrl_state=torch.ones((), dtype=torch.int32),
            velx=torch.full((), 0.3)))


@pytest.mark.parametrize("route", ["gj", "amortized", "reduced", "full"])
def test_three_ticks_match_jax(start, route, monkeypatch):
    calls = count_calls(monkeypatch, ["_gathered_polish", "_gathered_rescue",
                                      "batched_inverse_small"], [tb, tqp])
    syncs = tensors.host_syncs

    jc, pc = start["carry"], to_port(LoopCarry, start["carry"])
    jk = jb.make_kkt_carry(start["cfg"], B)
    pk = tb.make_kkt_carry(start["tcfg"], B, device=CPU)
    ages = []
    for tick in range(3):
        kw = dict(device=CPU, return_stats=True,
                  admm_backend="pallas_shared", **RESCUE)
        if route != "amortized":
            jc, jst = start[route](jc, start["trot"])
            pc, pst = tb.batched_closed_loop_step(
                start["tcfg"], start["pb"], start["terr"], pc, start["joy"],
                start["cfg"].control_dt,
                **ROUTE_KW.get(route, dict(kkt_backend=route)), **kw)
        else:
            jc, jk, jst = start["amortized"](jc, jk, start["trot"])
            pc, pk, pst = tb.batched_closed_loop_step(
                start["tcfg"], start["pb"], start["terr"], pc, start["joy"],
                start["cfg"].control_dt, kkt_backend="amortized",
                kkt_carry=pk, **AMORTIZED, **kw)
            np.testing.assert_array_equal(pk.age.numpy(), np.asarray(jk.age))
            ages.append(pk.age.tolist())
            if tick == 0:
                # later refreshes are built at the carried rho, estimated
                # from primal residuals at the float32 rounding floor
                # (steps of 2^-14), which any two float32 implementations
                # put up to ~10% apart; the ADMM fixed point, and so the
                # forces below, does not depend on rho
                assert_close(pk.minv, jk.minv, atol=1e-4 * float(
                    jnp.abs(jk.minv).max()))
        msg = f"{route} tick {tick}"
        assert_close(pc.cs.joint_torques, jc.cs.joint_torques, atol=5e-3,
                     err_msg=msg)
        assert_close(pc.cs.foot_forces_grf, jc.cs.foot_forces_grf,
                     atol=0.05, err_msg=msg)
        assert_close(pc.ps.root_pos, jc.ps.root_pos, atol=1e-6, err_msg=msg)
        for field in ("contacts", "plan_contacts"):
            np.testing.assert_array_equal(
                getattr(pc.cs, field).numpy(),
                np.asarray(getattr(jc.cs, field)), err_msg=msg)
        np.testing.assert_array_equal(pc.mem.mpc_flip_cooldown.numpy(),
                                      np.asarray(jc.mem.mpc_flip_cooldown))
    assert np.asarray(jc.mem.mpc_flip_cooldown).min() > 0, \
        "the window left the post-flip rescue window"
    if route == "amortized":
        # refresh-all, then one refresh per tick; the tie at tick 1 (both
        # ages 0) goes to the lower index, as jax.lax.top_k breaks it
        assert ages == [[0, 0], [0, 1], [1, 0]], ages
        assert calls["_gathered_polish"] >= 3
        assert calls["_gathered_rescue"] >= 1
    elif route == "full":   # a first rescue round every tick
        assert calls["_gathered_rescue"] >= 3
        assert calls["_gathered_polish"] == 0
    else:   # 'gj' and 'reduced' continue their flagged scenarios inline
        assert calls["_gathered_polish"] == calls["_gathered_rescue"] == 0
    # host reads a tick: none on 'gj', the overflow test on 'reduced',
    # the straggler round on 'full', four on 'amortized'
    # (parallel/batched.py's docstring)
    reads = {"gj": 0, "reduced": 1, "full": 1, "amortized": 4}[route]
    assert tensors.host_syncs - syncs == 3 * reads
    # K3 inverts the reduced block on 'reduced' only
    assert calls["batched_inverse_small"] == (3 if route == "reduced"
                                              else 0)


@pytest.mark.parametrize("k", [1, 3, 128, 1024])
def test_top_k_ties_take_the_lower_index(k, rng):
    """The refresh score age + 1e9 * must ties on most ticks: the port
    must rank it exactly as jax.lax.top_k does."""
    age = rng.integers(0, 4, 1024).astype(np.float32)
    must = rng.random(1024) < 0.05
    score = age + np.where(must, 1e9, 0.0).astype(np.float32)
    ref = np.asarray(jax.lax.top_k(jnp.asarray(score), k)[1])
    out = tb.top_k_indices(torch.from_numpy(score), k).numpy()
    np.testing.assert_array_equal(out, ref)


def test_convert_round_trips_state(start):
    """JAX pytrees (as nested NumPy dicts) -> the port's types -> back:
    values unchanged, float64 arrives as float32 and int64 as int32."""
    jk = jb.make_kkt_carry(start["cfg"], B)
    tree = jax_to_dict(jk)
    tree["c"] = tree["c"].astype(np.float64)
    tree["age"] = tree["age"].astype(np.int64) + np.arange(B)
    pk = convert.from_numpy(tb.KktCarry, tree, CPU)
    assert pk.c.dtype == torch.float32 and pk.age.dtype == torch.int32
    back = convert.to_numpy(pk)
    for name, ref in tree.items():
        np.testing.assert_array_equal(back[name], ref, err_msg=name)
    carry = convert.to_numpy(to_port(LoopCarry, start["carry"]))
    ref = jax_to_dict(start["carry"])
    assert carry.keys() == ref.keys()
    np.testing.assert_array_equal(carry["mem"]["ekf"]["P"],
                                  ref["mem"]["ekf"]["P"])
    np.testing.assert_array_equal(carry["cs"]["contacts"],
                                  ref["cs"]["contacts"])
