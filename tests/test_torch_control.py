"""One control tick of the port against the JAX package, from identical
state on ``gazebo_mpc``: ``control_tick_build`` (ingest, FSM, gait,
swing, EKF, terrain adaptation, the condensed MPC QP), the batched 'gj'
solve and the four routes that differ from it only in the KKT inverse,
``control_tick_finish`` (solution -> forces -> torques), and the
plant (terrain, standing start, sensors, one plant step).

Tolerances: the build is elementwise float32 work plus small products
summed in another order, so it agrees to ~1e-5 relative (the condensed
cost P reaches ~1e4, hence rtol 1e-5 with a small atol); through the
solve the tolerances are those of the batched-vs-single gate in
tests/test_parallel.py (torques 5e-3, forces 0.05 N)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu.config import load_profile as jload
from a1_qp_mpc_controller_tpu.control import grf as jgrf
from a1_qp_mpc_controller_tpu.control.controller import (
    control_tick_build as jbuild, control_tick_finish as jfinish,
)
from a1_qp_mpc_controller_tpu.models import srb as jsrb
from a1_qp_mpc_controller_tpu.ops import qp as jqp
from a1_qp_mpc_controller_tpu.ops.pallas_kernels import batched_inverse
from a1_qp_mpc_controller_tpu.parallel import batched as jbatched
from a1_qp_mpc_controller_tpu.sim import closed_loop as jcl
from a1_qp_mpc_controller_tpu.sim import plant as jplant
from a1_qp_mpc_controller_tpu.sim import terrain as jterrain
from a1_qp_mpc_controller_tpu.types import JoyCmd as JJoy
from a1_qp_mpc_controller_tpu_torch import config as tcfg
from a1_qp_mpc_controller_tpu_torch import types as tt
from a1_qp_mpc_controller_tpu_torch.control import controller as tctl
from a1_qp_mpc_controller_tpu_torch.ops import qp as tqp
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tbatched
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as tcl
from a1_qp_mpc_controller_tpu_torch.sim import plant as tplant
from a1_qp_mpc_controller_tpu_torch.sim import terrain as tterrain

from torch_parity import (
    CPU, assert_close, assert_tree_close, bench_state, t, to_port,
)

B = 3
SCHEDULE = dict(mpc_qp_iters=25, mpc_solver_mode="fixed",
                mpc_cooldown_ticks=32, mpc_cooldown_stride=4,
                mpc_cooldown_dense=12, mpc_drift_rescue_n=0.5)


@pytest.fixture(scope="module")
def tick():
    """The JAX package's bench state (trot command) and its build,
    solve and finish of one tick; the same state in the port."""
    cfg, params = jload("gazebo_mpc")
    cfg = dataclasses.replace(cfg, **SCHEDULE)
    pb, cs, mem, sens = bench_state(cfg, 4, B, params)
    # stagger the gait so the batch mixes 2- and 4-stance scenarios
    gc = np.array([[30.0, 150.0, 150.0, 30.0], [30.0, 60.0, 60.0, 30.0],
                   [100.0, 220.0, 220.0, 100.0]], np.float32)
    cs = cs.replace(gait_counter=jnp.asarray(gc))
    joy = JJoy.zeros().replace(ctrl_state=jnp.int32(1),
                               velx=jnp.float32(0.3))
    dt = jnp.float32(cfg.control_dt)
    settings = jqp.QPSettings(rho=jgrf._MPC_RHO0, adaptive_rho=False)

    @jax.jit
    def build(pb, cs, mem, sens):
        cs2, mem2, prob = jax.vmap(lambda p, c, m, s: jbuild(
            cfg, p, c, m, s, joy, dt, with_a_mat=False))(pb, cs, mem, sens)
        scal = jax.vmap(lambda tb, c, p, q: jqp.rescale_cost(
            p, q, jgrf.scaling_for_contacts(tb, c)))(
            mem2.mpc_scaling_table, cs2.contacts, prob.p_mat, prob.q_vec)
        return cs2, mem2, prob, scal

    @jax.jit
    def solve(prob, scal, mu):
        base, slope = jsrb.friction_basis_blocks()
        m_b = jqp.scaled_kkt_matrix_blockdiag(
            prob.p_mat, base, slope, mu, prob.lb, prob.ub, settings,
            prob.rho0, scal)
        minv = batched_inverse(m_b, block=B, interpret=True)
        a0, a1 = jsrb.friction_constraint_basis(cfg.horizon)
        return jqp.admm_solve_fixed_batched_shared(
            prob.p_mat, prob.q_vec, a0, a1, mu, prob.lb, prob.ub,
            cfg.mpc_qp_iters, settings, prob.warm_x, prob.warm_y, prob.rho0,
            scal, minv, block=B, interpret=True)

    cs2, mem2, prob, scal = build(pb, cs, mem, sens)
    sol = solve(prob, scal, pb.mu_mpc)
    fin = jax.jit(jax.vmap(lambda p, c, m, s: jfinish(cfg, p, c, m, s)))(
        pb, cs2, mem2, sol)
    tick_j = jax.jit(lambda pb, cs, mem, sens: jbatched.batched_control_tick(
        cfg, pb, cs, mem, sens, joy, dt, admm_backend="pallas_shared",
        kkt_backend="gj", kkt_block=B, admm_block=B, rescue_capacity=2,
        rescue_iters=150, interpret=True))(pb, cs, mem, sens)

    tcfg_, _ = tcfg.load_profile("gazebo_mpc", device=CPU)
    tjoy = tt.JoyCmd.zeros(device=CPU).replace(
        ctrl_state=torch.ones((), dtype=torch.int32),
        velx=torch.full((), 0.3))
    return dict(
        cfg=dataclasses.replace(tcfg_, **SCHEDULE), joy=tjoy,
        dt=torch.full((), cfg.control_dt),
        pb=to_port(tcfg.RobotParams, pb), cs=to_port(tt.CtrlState, cs),
        mem=to_port(tt.CtrlMem, mem), sens=to_port(tt.SensorData, sens),
        j_build=(cs2, mem2, prob, scal), j_sol=sol, j_fin=fin,
        j_tick=tick_j)


def test_build_matches_jax(tick):
    from a1_qp_mpc_controller_tpu_torch.control import grf as tgrf

    cs, mem, prob = tctl.control_tick_build(
        tick["cfg"], tick["pb"], tick["cs"], tick["mem"], tick["sens"],
        tick["joy"], tick["dt"])
    j_cs, j_mem, j_prob, j_scal = tick["j_build"]
    assert 0 < int(j_cs.contacts.sum()) < 4 * B, "batch is not mixed"
    assert_tree_close(cs, j_cs, atol=1e-5, rtol=1e-5, scale_tol=1e-6)
    assert_tree_close(mem, j_mem, atol=1e-5, rtol=1e-5, scale_tol=1e-6)
    # a_mat: None in the JAX build (with_a_mat=False), absent in the port
    assert_tree_close(prob, j_prob, atol=1e-3, rtol=1e-5, skip=("a_mat",))
    scal = tqp.rescale_cost(prob.p_mat, prob.q_vec, tgrf.scaling_for_contacts(
        mem.mpc_scaling_table, cs.contacts))
    assert_tree_close(scal, j_scal, atol=1e-7, rtol=1e-5)


def test_finish_matches_jax_on_the_same_solution(tick):
    """control_tick_finish from the JAX build and solution: warm-start
    memory, forces and torques agree to float32 rounding."""
    j_cs, j_mem, _, _ = tick["j_build"]
    cs, mem, tq = tctl.control_tick_finish(
        tick["cfg"], tick["pb"], to_port(tt.CtrlState, j_cs),
        to_port(tt.CtrlMem, j_mem), to_port(tqp.QPSolution, tick["j_sol"]))
    f_cs, f_mem, f_tq = tick["j_fin"]
    assert_close(tq, f_tq, atol=1e-4, rtol=1e-5)
    assert_tree_close(cs, f_cs, atol=1e-4, rtol=1e-5)
    assert_tree_close(mem, f_mem, atol=1e-5, rtol=1e-5)


def test_batched_tick_gj_matches_jax(tick):
    """build -> Gauss-Jordan inverse -> fused ADMM -> flip rescue ->
    finish, the whole 'gj' tick, against the JAX package with its Pallas
    kernels in interpret mode."""
    cs, mem, tq = tbatched.batched_control_tick(
        tick["cfg"], tick["pb"], tick["cs"], tick["mem"], tick["sens"],
        tick["joy"], tick["dt"], admm_backend="pallas_shared",
        kkt_backend="gj", rescue_capacity=2, rescue_iters=150)
    j_cs, j_mem, j_tq = tick["j_tick"]
    assert_close(tq, j_tq, atol=5e-3)
    assert_close(cs.foot_forces_grf, j_cs.foot_forces_grf, atol=0.05)
    np.testing.assert_array_equal(mem.mpc_flip_cooldown.numpy(),
                                  np.asarray(j_mem.mpc_flip_cooldown))


@pytest.mark.parametrize("kkt_backend", ["chol", "schur", "sweep_t", "gj_t"])
def test_batched_tick_other_inverses_match_jax_gj(tick, kkt_backend):
    """The per-tick-refactor routes that differ from 'gj' only in the KKT
    inverse (blocked Cholesky, Schur recursion, batch-last sweep and
    Gauss-Jordan), each against the JAX package's 'gj' tick at that
    test's tolerances: every inverse solves the same KKT systems, so the
    fused ADMM reaches the same answer."""
    cs, mem, tq = tbatched.batched_control_tick(
        tick["cfg"], tick["pb"], tick["cs"], tick["mem"], tick["sens"],
        tick["joy"], tick["dt"], admm_backend="pallas_shared",
        kkt_backend=kkt_backend, rescue_capacity=2, rescue_iters=150)
    j_cs, j_mem, j_tq = tick["j_tick"]
    assert_close(tq, j_tq, atol=5e-3)
    assert_close(cs.foot_forces_grf, j_cs.foot_forces_grf, atol=0.05)
    np.testing.assert_array_equal(mem.mpc_flip_cooldown.numpy(),
                                  np.asarray(j_mem.mpc_flip_cooldown))


def test_unported_routes_raise(tick):
    """An unknown ``kkt_backend`` raises ``ValueError`` listing the known
    ones (the JAX package would run 'gj' for it); the stand-QP branch of
    ``compute_grf`` runs the tick on ``gazebo_qp`` (its stance control
    type 0; tests/test_torch_stand.py holds it against the JAX
    package)."""
    qp_cfg, _ = tcfg.load_profile("gazebo_qp", device=CPU)
    args = (tick["pb"], tick["cs"], tick["mem"], tick["sens"], tick["joy"],
            tick["dt"])
    _, _, tq = tctl.control_tick(qp_cfg, *args)
    assert bool(torch.isfinite(tq).all())
    with pytest.raises(ValueError, match="'lu'") as err:
        tbatched.batched_control_tick(
            tick["cfg"], *args, admm_backend="pallas_shared",
            kkt_backend="lu")
    for name in ("amortized", "reduced", "reduced_admm", "gj", "chol",
                 "schur", "sweep_t", "gj_t"):
        assert repr(name) in str(err.value)


def test_plant_matches_jax(rng):
    """Standing start (plant state, controller state and memory with its
    scaling table), terrain heights, sensor synthesis and one plant step
    under random torques, on randomized params and terrain."""
    cfg, params = jload("gazebo_mpc")
    key = jax.random.PRNGKey(2)
    pb = jbatched.randomize_params(key, 2, params)
    terr = jbatched.randomize_terrain(jax.random.PRNGKey(5), 2)
    carry = jax.jit(jax.vmap(lambda p, tr: jcl.make_standing_start(
        cfg, p, tr)))(pb, terr)
    tcfg_, _ = tcfg.load_profile("gazebo_mpc", device=CPU)
    tpb = to_port(tcfg.RobotParams, pb)
    tterr = to_port(tterrain.Terrain, terr)
    tcarry = tcl.make_standing_start(tcfg_, tpb, tterr, device=CPU)
    assert_tree_close(tcarry, carry, atol=1e-6, rtol=1e-5)

    xy = rng.uniform(-1.0, 9.0, (2, 7, 2)).astype(np.float32)
    ref_h = jax.vmap(jterrain.height)(terr, jnp.asarray(xy[..., 0]),
                                      jnp.asarray(xy[..., 1]))
    assert_close(tterrain.height(tterr, t(xy[..., 0]), t(xy[..., 1])), ref_h,
                 atol=1e-6)

    dt = jnp.float32(cfg.control_dt)
    ps = carry.ps.replace(root_lin_vel=carry.ps.root_lin_vel + jnp.asarray(
        0.1 * rng.standard_normal((2, 3)), jnp.float32))
    sens = jax.jit(jax.vmap(lambda p, s, v: jplant.read_sensors(
        p, s, v, dt)))(pb, ps, carry.prev_root_lin_vel)
    tps = to_port(tplant.PlantState, ps)
    tsens = tplant.read_sensors(tpb, tps, tcarry.prev_root_lin_vel,
                                torch.full((), cfg.control_dt))
    assert_tree_close(tsens, sens, atol=1e-4, rtol=1e-5)

    tq = (5.0 * rng.standard_normal((2, 12))).astype(np.float32)
    ps1 = jax.jit(jax.vmap(lambda p, tr, s, q: jplant.plant_step(
        p, tr, s, q, dt, 5)))(pb, terr, ps, jnp.asarray(tq))
    tps1 = tplant.plant_step(tpb, tterr, tps, t(tq),
                             torch.full((), cfg.control_dt), 5)
    assert_tree_close(tps1, ps1, atol=1e-5, rtol=1e-5)
