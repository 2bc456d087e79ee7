"""The port's single-scenario solves and tick over a batch against the JAX
package under ``vmap``, and the 'xla' route of the batched tick, from
one closed-loop start (``torch_parity.stood_start``: B = 4 scenarios
stood up by the port, then trotting, so each flips its contacts on the
first tick; later ticks of a stalled solve amplify float32 noise, so the
parity window is the first ticks after the start).

- ``admm_solve`` (adaptive, cold started so the scenarios stop after
  different numbers of blocks and change their stepsize on the way) and
  ``admm_solve_fixed`` (warm started, with and without the inverse
  given) on the MPC QPs that ``control_tick_build`` makes from that
  start: iteration counts and convergence exactly, forces within 0.05 N,
  the whole primal within 0.05 (N, over the horizon), the carried rho
  within a factor of 2 (it is estimated from residuals near the float32
  floor). The batched adaptive solve also equals the first and the last
  scenario to stop solved alone, in float64, to 1e-9.
- ``control_tick`` over the batch against ``jax.vmap(control_tick)``,
  two closed-loop ticks in fixed mode and in adaptive mode. Fixed mode
  runs with the flip rescue and the round-robin polish (every third
  tick) on, a 4-tick post-flip window and no drift trigger, so that the
  rescue is taken by all scenarios on the flip tick and by one on the
  next, and the polish by all on that next tick.
- ``batched_control_tick(admm_backend='xla')`` with ``use_pallas`` False
  (``torch.linalg.inv``) and True (K1, its plain version here), two
  ticks, against the JAX package's 'xla' route.
The ticks are held to the limits of the 'gj' route test (torques
5e-3 N m, forces 0.05 N; tests/test_parallel.py), with contacts and
cooldown counters equal. One jitted JAX function serves the file.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu.control import grf as jgrf
from a1_qp_mpc_controller_tpu.control.controller import (
    control_tick as jtick,
)
from a1_qp_mpc_controller_tpu.ops import qp as jqp
from a1_qp_mpc_controller_tpu.parallel import batched as jbatched
from a1_qp_mpc_controller_tpu.sim import closed_loop as jcl
from a1_qp_mpc_controller_tpu.sim import plant as jplant
from a1_qp_mpc_controller_tpu_torch import convert, tensors
from a1_qp_mpc_controller_tpu_torch.control import controller as tctl
from a1_qp_mpc_controller_tpu_torch.control import grf as tgrf
from a1_qp_mpc_controller_tpu_torch.ops import qp as tqp
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tbatched
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as tcl
from a1_qp_mpc_controller_tpu_torch.sim import plant as tplant

from torch_parity import CPU, assert_close, stood_start

B = 4
FIXED = dict(mpc_rescue_iters=25, mpc_polish_every=3, mpc_polish_iters=25,
             mpc_cooldown_ticks=4, mpc_cooldown_dense=0,
             mpc_drift_rescue_n=0.0)
ADAPTIVE = dict(mpc_solver_mode="adaptive", mpc_qp_iters=100)
SOLVE = dict(rho=jgrf._MPC_RHO0, eps_abs=1e-5, eps_rel=1e-5, max_iter=200,
             check_every=25)


@partial(jax.jit, static_argnames=("cfg", "what"))
def _jax(cfg, what, *args):
    """The JAX side of every test: 'solve' / 'fixed' a batch of QPs, or
    one closed-loop 'tick' / 'xla' step."""
    if what == "solve":
        prob, scal = args
        return jax.vmap(lambda pr, sc: jqp.admm_solve(
            pr.p_mat, pr.q_vec, pr.a_mat, pr.lb, pr.ub,
            jqp.QPSettings(**SOLVE), scaling=sc))(prob, scal)
    if what == "fixed":
        prob, scal, minv = args
        settings = jqp.QPSettings(rho=jgrf._MPC_RHO0, adaptive_rho=False)
        return jax.vmap(lambda pr, sc, mi: jqp.admm_solve_fixed(
            pr.p_mat, pr.q_vec, pr.a_mat, pr.lb, pr.ub, 50, settings,
            x0=pr.warm_x, y0=pr.warm_y, rho0=pr.rho0, scaling=sc,
            kkt_inv=mi))(prob, scal, minv)
    pb, terr, carry, joy, dt = args
    if what == "xla":
        return jbatched.batched_closed_loop_step(cfg, pb, terr, carry, joy,
                                                 dt, admm_backend="xla")
    sens = jax.vmap(lambda p, s, v: jplant.read_sensors(p, s, v, dt))(
        pb, carry.ps, carry.prev_root_lin_vel)
    cs, mem, tq = jax.vmap(lambda p, c, m, s: jtick(
        cfg, p, c, m, s, joy, dt))(pb, carry.cs, carry.mem, sens)
    ps = jax.vmap(lambda p, tr, s, q: jplant.plant_step(
        p, tr, s, q, dt, 5))(pb, terr, carry.ps, tq)
    return jcl.LoopCarry(cs=cs, mem=mem, ps=ps,
                         prev_root_lin_vel=carry.ps.root_lin_vel)


@pytest.fixture(scope="module")
def start():
    return stood_start(B, dict(rescue_capacity=2, rescue_iters=150))


@pytest.fixture(scope="module")
def qps(start):
    """The MPC QPs of the first trot tick from the start (with the
    materialized A), built by the port and handed to the JAX package."""
    c, dt = start["tcarry"], torch.full((), start["tcfg"].control_dt)
    sens = tplant.read_sensors(start["tpb"], c.ps, c.prev_root_lin_vel, dt)
    cs, mem, tprob = tctl.control_tick_build(
        start["tcfg"], start["tpb"], c.cs, c.mem, sens, start["tjoy"], dt,
        with_a_mat=True)
    tscal = tqp.rescale_cost(tprob.p_mat, tprob.q_vec,
                             tgrf.scaling_for_contacts(mem.mpc_scaling_table,
                                                       cs.contacts))
    as_jax = lambda cls, obj: cls(**{k: jnp.asarray(v) for k, v in
                                     convert.to_numpy(obj).items()})
    return (as_jax(jgrf.MpcProblem, tprob), as_jax(jqp.Scaling, tscal),
            tprob, tscal)


def _sol_close(sol, ref, what):
    np.testing.assert_array_equal(sol.iters.numpy(), np.asarray(ref.iters),
                                  err_msg=what)
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged), err_msg=what)
    assert_close(sol.x[:, :12], ref.x[:, :12], atol=0.05, err_msg=what)
    assert_close(sol.x, ref.x, atol=0.05, err_msg=what)
    ratio = sol.rho.numpy() / np.asarray(ref.rho)
    assert np.all((ratio > 0.5) & (ratio < 2.0)), (what, ratio)


def test_admm_solve_matches_jax_and_each_scenario_alone(qps):
    """Cold-started adaptive solves to 1e-5 within 200 iterations: the
    scenarios stop after different block counts, and the stepsize moves
    (refactoring only the scenarios whose rho moved)."""
    prob, scal, tprob, tscal = qps
    ref = _jax(None, "solve", prob, scal)
    settings = tqp.QPSettings(**SOLVE)
    args = (tprob.p_mat, tprob.q_vec, tprob.a_mat, tprob.lb, tprob.ub,
            settings)
    before = tensors.host_syncs
    sol = tqp.admm_solve(*args, scaling=tscal)
    reads = tensors.host_syncs - before
    _sol_close(sol, ref, "admm_solve")
    iters = sol.iters.numpy()
    assert len(set(iters)) > 1, iters          # scenarios stop apart
    assert not np.allclose(sol.rho.numpy(), SOLVE["rho"])
    # one read after each block but the last possible one
    n_blocks = SOLVE["max_iter"] // SOLVE["check_every"]
    assert reads == min(iters.max() // SOLVE["check_every"], n_blocks - 1)
    # each scenario alone, in float64 so that only a scenario that kept
    # moving after its stop (or took another's refactor) could differ
    args64 = [a.double() for a in args[:5]]
    scal64 = tensors.tree_map(lambda a: a.double(), tscal)
    both = tqp.admm_solve(*args64, settings, scaling=scal64)
    for i in (int(np.argmin(iters)), int(np.argmax(iters))):
        one = tqp.admm_solve(*(a[i:i + 1] for a in args64), settings,
                             scaling=tensors.tree_map(lambda a: a[i:i + 1],
                                                      scal64))
        assert int(one.iters) == int(both.iters[i])
        assert_close(one.x[0], both.x[i], atol=1e-9, rtol=1e-9,
                     err_msg=f"alone {i}")


@pytest.mark.parametrize("given", [False, True])
def test_admm_solve_fixed_matches_jax(qps, given):
    """Warm-started 50-iteration solves, the KKT inverse given or made
    inside; no host read."""
    prob, scal, tprob, tscal = qps
    settings = tqp.QPSettings(rho=tgrf._MPC_RHO0, adaptive_rho=False)
    minv = torch.linalg.inv(tqp.scaled_kkt_matrix(
        tprob.p_mat, tprob.q_vec, tprob.a_mat, tprob.lb, tprob.ub, settings,
        tprob.rho0, tscal))
    ref = _jax(None, "fixed", prob, scal, jnp.asarray(minv.numpy()))
    before = tensors.host_syncs
    sol = tqp.admm_solve_fixed(
        tprob.p_mat, tprob.q_vec, tprob.a_mat, tprob.lb, tprob.ub, 50,
        settings, x0=tprob.warm_x, y0=tprob.warm_y, rho0=tprob.rho0,
        scaling=tscal, kkt_inv=minv if given else None)
    assert tensors.host_syncs == before
    _sol_close(sol, ref, f"admm_solve_fixed, inverse given {given}")


def _ticks_match(start, cfg_kw, port_step, what, ticks=2):
    cfg = dataclasses.replace(start["cfg"], **cfg_kw)
    tcfg = dataclasses.replace(start["tcfg"], **cfg_kw)
    jc, pc = start["carry"], start["tcarry"]
    for tick in range(ticks):
        jc = _jax(cfg, what, start["pb"], start["terr"], jc, start["trot"],
                  start["dt"])
        pc = port_step(tcfg, pc)
        msg = f"{what} {cfg_kw} tick {tick}"
        assert_close(pc.cs.joint_torques, jc.cs.joint_torques, atol=5e-3,
                     err_msg=msg)
        assert_close(pc.cs.foot_forces_grf, jc.cs.foot_forces_grf,
                     atol=0.05, err_msg=msg)
        np.testing.assert_array_equal(pc.cs.contacts.numpy(),
                                      np.asarray(jc.cs.contacts),
                                      err_msg=msg)
        np.testing.assert_array_equal(pc.mem.mpc_flip_cooldown.numpy(),
                                      np.asarray(jc.mem.mpc_flip_cooldown),
                                      err_msg=msg)
    assert np.asarray(jc.mem.mpc_flip_cooldown).max() > 0, \
        "no scenario is in the post-flip rescue window"


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_control_tick_matches_vmapped_jax(start, mode, monkeypatch):
    masks = []

    def select(mask, a, b):
        masks.append(mask.numpy())
        return tensors.select_tree(mask, a, b)
    monkeypatch.setattr(tgrf, "select_tree", select)

    def step(tcfg, c):
        dt = torch.full((), tcfg.control_dt)
        sens = tplant.read_sensors(start["tpb"], c.ps, c.prev_root_lin_vel,
                                   dt)
        cs, mem, tq = tctl.control_tick(tcfg, start["tpb"], c.cs, c.mem,
                                        sens, start["tjoy"], dt)
        ps = tplant.plant_step(start["tpb"], start["tterr"], c.ps, tq, dt, 5)
        return tcl.LoopCarry(cs=cs, mem=mem, ps=ps,
                             prev_root_lin_vel=c.ps.root_lin_vel)

    _ticks_match(start, FIXED if mode == "fixed" else ADAPTIVE, step, "tick")
    if mode == "fixed":   # (keep first pass, take polish) for each tick
        keep, polish = np.array(masks[0::2]), np.array(masks[1::2])
        assert not keep[0].any() and 0 < keep[1].sum() < B, keep
        assert not polish[0].any() and polish[1].all(), polish
    else:
        assert not masks


@pytest.mark.parametrize("use_pallas", [False, True])
def test_xla_route_matches_jax(start, use_pallas):
    """The default route: each port variant against the JAX package's
    'xla' route with ``jnp.linalg.inv`` (the two inverses solve the
    same systems)."""
    def step(tcfg, c):
        return tbatched.batched_closed_loop_step(
            tcfg, start["tpb"], start["tterr"], c, start["tjoy"],
            tcfg.control_dt, device=CPU, use_pallas=use_pallas)

    _ticks_match(start, {}, step, "xla")
