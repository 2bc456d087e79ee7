"""The port's golden-gate layer against the JAX package
(``sim/closed_loop.rollout``, ``runtime/golden``):

- ``rebuild_mpc_qp`` and ``rebuild_stand_qp`` against the JAX functions
  under ``jax.jit``, vmapped, on trotting states from
  ``torch_parity.stood_start`` (B = 4, each scenario's first trot tick,
  so that some flip their contacts): every field within 1e-5 of its
  scale (float32 products summed in another order), the bounds exactly;
- ``rollout`` against the JAX ``rollout`` from one standing start: 20
  ticks of ``control_tick`` (the bench schedule), standing through the
  10-tick torque warm-up and then walking; every Trace field within its
  stated limit after each tick;
- ``run_gate`` at a short fixed-mode protocol (the shipped schedule
  with its 150-iteration rescue, 0.1 s, onset at 0.04 s, every 3rd
  tick) with the OSQP-default columns: every sample within 2 N, no NaN;
- ``run_amortized_gate``'s code path at B = 4 on both backends, a few
  ticks after an early onset;
- the committed draws of the amortized gate equal the JAX package's
  ``make_flat_batch(cfg, PRNGKey(7), 16, params)`` exactly, and the
  port's batch is built from them.
- the amortized gate's schedule and tick arguments equal ``bench.py``'s
  as the JAX gate's script scales them.

The port's counterparts of ``tests/test_golden.py``'s 2 s protocols run
under ``slow``. Its slope test has none yet: the port's ``Terrain`` is
flat only (ROADMAP.md, section 1, item 4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from a1_qp_mpc_controller_tpu.config import load_profile as jload
from a1_qp_mpc_controller_tpu.parallel import batched as jbatched
from a1_qp_mpc_controller_tpu.runtime import golden as jgolden
from a1_qp_mpc_controller_tpu.sim import closed_loop as jcl
from a1_qp_mpc_controller_tpu_torch.config import load_profile
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tbatched
from a1_qp_mpc_controller_tpu_torch.runtime import golden
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as tcl
from a1_qp_mpc_controller_tpu_torch.tensors import broadcast_batch
from torch_parity import (
    CPU, SCHEDULE, assert_close, assert_tree_close, stood_start, to_jax,
)

B = 4
STAND_TICKS = 5        # stood_start's stand before the trot tick
QP_REL = 1e-5          # of each QP field's largest finite entry
ROLLOUT_TICKS, WARMUP = 20, 10
# rollout: limits after each of 20 ticks of two float32 codes of one
# controller: tests/test_parallel.py's torques and forces, the plant's
# state to float32 noise, the EKF's estimate to its noise (3.4e-5 m
# seen). Through the torque warm-up the robot stands on four legs and
# its torques are zero: the forces' internal directions are near-flat
# there, and float32 rounding moves them by up to 0.072 N (seen) without
# reaching the plant, so they get the stand QP's 0.15 N
# (tests/test_torch_stand.py) until the walk starts.
TRACE_TOL = dict(joint_torques=5e-3, foot_forces_grf=0.05,
                 foot_force_sensor=0.05, root_pos=1e-6, est_root_pos=1e-4,
                 root_euler_est=1e-6, root_lin_vel=1e-5, swing_target=1e-6,
                 swing_actual=1e-6, swing_err=1e-6)
WARMUP_FORCE_TOL = 0.15


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The float64 reference solves (NumPy, ``ops/qp_ref``) on one BLAS
    thread: beside the suite's other workers, OpenBLAS's spinning threads
    made them ~40x slower (a gate test 82.8 s in a full run, 2.2 s
    alone)."""
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _qp_close(port_qp, jax_qp):
    for name, p, j in zip("PqAlu", port_qp, jax_qp):
        j = np.asarray(j)
        p = p.numpy()
        if name in "lu":
            np.testing.assert_array_equal(p, j, err_msg=name)
            continue
        scale = float(np.abs(j).max())
        np.testing.assert_allclose(p, j, atol=QP_REL * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("profile", ["gazebo_mpc", "gazebo_qp"])
def test_rebuild_qp_matches_jax(profile):
    """The rebuilt QP of each scenario's first trot tick against the JAX
    package's rebuild of the same state."""
    rescue = dict(rescue_capacity=2, rescue_iters=150)
    s = stood_start(B, rescue, stand_ticks=STAND_TICKS, profile=profile)
    pc = tbatched.batched_closed_loop_step if profile == "gazebo_mpc" \
        else tbatched.batched_stand_closed_loop_step
    kw = (dict(admm_backend="pallas_shared", kkt_backend="gj", **rescue)
          if profile == "gazebo_mpc" else rescue)
    carry = pc(s["tcfg"], s["tpb"], s["tterr"], s["tcarry"], s["tjoy"],
               s["tcfg"].control_dt, device=CPU, **kw)
    cs = to_jax(jax.eval_shape(lambda c: c, s["carry"].cs), carry.cs)
    dt = torch.full((), s["tcfg"].control_dt)
    if profile == "gazebo_mpc":
        got = golden.rebuild_mpc_qp(s["tcfg"], s["tpb"], carry.cs, dt)
        want = jax.jit(jax.vmap(lambda p, c: jgolden.rebuild_mpc_qp(
            s["cfg"], p, c, s["dt"])))(s["pb"], cs)
    else:
        got = golden.rebuild_stand_qp(s["tcfg"], s["tpb"], carry.cs)
        want = jax.jit(jax.vmap(lambda p, c: jgolden.rebuild_stand_qp(
            s["cfg"], p, c)))(s["pb"], cs)
    assert got[0].shape[0] == B
    _qp_close(got, want)
    contacts = carry.cs.contacts.numpy()
    assert contacts.any() and not contacts.all(), "no scenario trots"


def test_rollout_matches_jax():
    """``rollout`` from one standing start (the port's, handed to both):
    the torque warm-up standing, then the walk; the Trace of every tick
    against the JAX package's vmapped ``rollout``."""
    cfg, params = jload("gazebo_mpc")
    cfg = dataclasses.replace(cfg, **SCHEDULE)
    tcfg, tparams = load_profile("gazebo_mpc", device=CPU)
    tcfg = dataclasses.replace(tcfg, **SCHEDULE)
    tpb, tterr, tcarry = tbatched.flat_batch_from_params(
        tcfg, broadcast_batch(tparams, 1), device=CPU)
    shapes = jax.eval_shape(lambda key: jbatched.make_flat_batch(
        cfg, key, 1, params), jax.random.PRNGKey(0))
    pb, terr, carry = (to_jax(sh, o)
                       for sh, o in zip(shapes, (tpb, tterr, tcarry)))
    n = ROLLOUT_TICKS
    jjoy = jcl.joy_schedule(n, walk_after=WARMUP, velx=0.3)
    tjoy = tcl.joy_schedule(n, walk_after=WARMUP, velx=0.3, device=CPU)
    jcarry, jtrace = jax.jit(jax.vmap(
        lambda p, t, c: jcl.rollout(cfg, p, t, c, jjoy, n)))(pb, terr, carry)
    tcarry, ttrace = tcl.rollout(tcfg, tpb, tterr, tcarry, tjoy, n,
                                 device=CPU)
    # (B, T, ...) -> (T, B, ...)
    jtrace = jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), jtrace)
    assert ttrace.root_pos.shape == (n, 1, 3)
    np.testing.assert_array_equal(ttrace.contacts.numpy(),
                                  np.asarray(jtrace.contacts))
    assert not np.asarray(jtrace.contacts)[-1].all(), "no leg swings"
    for field, tol in TRACE_TOL.items():
        got, want = getattr(ttrace, field), np.asarray(getattr(jtrace, field))
        if field == "foot_forces_grf":
            assert_close(got[:WARMUP], want[:WARMUP], atol=WARMUP_FORCE_TOL,
                         err_msg=field)
            got, want = got[WARMUP:], want[WARMUP:]
        assert_close(got, want, atol=tol, err_msg=field)
    assert torch.equal(tcarry.ps.root_pos, ttrace.root_pos[-1])


def test_run_gate_fixed_short():
    """``run_gate`` on the shipped fixed schedule (25 iterations, the
    150-iteration rescue over the strided cooldown window, the drift
    trigger) at a short protocol, with the OSQP-default columns."""
    rep = golden.run_gate(seconds=0.1, sample_every=3, walk_after_s=0.04,
                          solver_mode="fixed", mpc_iters=25,
                          rescue_iters=150, cooldown_ticks=32,
                          cooldown_stride=4, cooldown_dense=12,
                          drift_rescue_n=0.5, ref_fidelity_baseline=True,
                          verbose=False, device=CPU)
    assert rep["samples"] == 8
    assert not rep["nan"]
    assert np.isfinite(rep["max_dev_N"])
    assert rep["frac_within_tol"] == 1.0, rep
    assert np.isfinite(rep["ref_osqp_default_max_dev_N"])


@pytest.mark.parametrize("backend", golden.GATE_BACKENDS)
def test_amortized_gate_path(backend):
    """The amortized gate's code path at B = 4: 10 ticks, the onset at
    the 6th, every 2nd tick sampled."""
    rep = golden.run_amortized_gate(seconds=0.025, batch=B, sample_every=2,
                                    walk_after_s=0.015, backend=backend,
                                    device=CPU)
    assert rep["samples"] == 2 * B
    assert rep["scenarios"] == B and rep["alive_frac"] == 1.0
    assert not rep["nan"] and np.isfinite(rep["max_dev_N"])
    assert len(rep["worst"]) == min(golden.WORST, 2 * B)
    ages = [w["age"] for w in rep["worst"]]
    assert (max(ages) < B) if backend == "amortized" else \
        (min(ages) == 1_000_000)


def test_gate_draws_equal_jax():
    """The committed draws are the params of the JAX package's
    ``make_flat_batch`` of seed 7 at B = 16, exactly; the port's batch
    (``flat_batch_from_params``) takes them as they are, and a gate of
    fewer scenarios takes the first ones."""
    cfg, params = jload("gazebo_mpc")
    jpb = jax.jit(lambda k: jbatched.make_flat_batch(cfg, k, 16, params)[0])(
        jax.random.PRNGKey(golden.GATE_SEED))
    tcfg, tparams = load_profile("gazebo_mpc", device=CPU)
    tpb, tterr, tcarry = tbatched.flat_batch_from_params(
        tcfg, golden.gate_params(tparams, 16, device=CPU), device=CPU)
    assert_tree_close(tpb, jpb, atol=0.0)
    assert tterr.pitch.shape == (16,) and not tterr.step_height.any()
    assert torch.equal(tcarry.cs.root_pos, tcarry.ps.root_pos)
    first = golden.gate_params(tparams, 4, device=CPU)
    assert torch.equal(first.mu_mpc, tpb.mu_mpc[:4])
    with pytest.raises(ValueError, match="draws hold 16"):
        golden.gate_params(tparams, 17, device=CPU)


@pytest.mark.parametrize("backend", golden.GATE_BACKENDS)
def test_gate_schedule_matches_bench(backend):
    """The amortized gate's configuration and tick arguments are the JAX
    gate's, taken from ``bench.py`` as
    ``scripts/run_golden_amortized.py`` takes them: ``bench.build()``'s
    schedule over the profile, and ``bench._tick_kwargs`` with the
    capacities scaled to the batch (the Pallas block sizes aside, which
    the port does not take)."""
    from compare_amortized_gate import bench_gate_args

    base, _ = jload("gazebo_mpc")
    for batch in (4, 16):
        cfg, _, kw = bench_gate_args(backend, batch)
        assert dataclasses.replace(base, **golden.BENCH_SCHEDULE) == cfg
        kw = {k: v for k, v in kw.items()
              if k not in ("admm_block", "kkt_block")}
        assert golden.gate_tick_kwargs(backend, batch) == kw, batch


@pytest.mark.slow
def test_gate_adaptive_2s():
    """``tests/test_golden.py``'s adaptive protocol and limits."""
    rep = golden.run_gate(seconds=2.0, sample_every=40, verbose=False,
                          device=CPU)
    assert not rep["nan"]
    assert rep["samples"] >= 10
    assert rep["max_dev_N"] < 1.5
    assert rep["mean_dev_N"] < 0.3
    assert rep["frac_within_tol"] == 1.0


# the fixed-mode 2 s gate: a sample's forces from the port's tick and from
# the JAX package's tick on the same state (two float32 codes of fixed
# 50-iteration ADMM part by up to 0.073 N seen on a trot tick)
FIXED_TICK_F_TOL = 0.1


@pytest.mark.slow
def test_gate_fixed_2s():
    """``tests/test_golden.py``'s fixed-mode protocol (2 s, 50
    iterations, every 37th tick from the onset) on the port, its p95
    and max limits; and, at each sample, the JAX package's
    ``control_tick`` from the port's state before that tick, whose
    forces must be the port's within FIXED_TICK_F_TOL. That JAX tick,
    not the JAX test's share within 2 N, is the reference here: the
    port's trajectory is not the JAX one (float32 chaos), and a sample
    that lands one tick after a touchdown sits over 2 N from the optimum
    on both packages' ticks (t = 474: 2.225 N on the port, 2.223 N on
    the JAX tick from its state; ``GOLDEN_REPORT.json`` ``fixed_50it``
    leaves 1.7% of its samples over 2 N)."""
    import jax.tree_util as jtu

    from a1_qp_mpc_controller_tpu.control.controller import (
        control_tick as jtick,
    )
    from a1_qp_mpc_controller_tpu.sim import plant as jplant
    from a1_qp_mpc_controller_tpu_torch.ops import qp_ref
    from a1_qp_mpc_controller_tpu_torch.sim import terrain as tterrain
    from a1_qp_mpc_controller_tpu_torch.tensors import tree_map

    over = dict(mpc_qp_iters=50, mpc_solver_mode="fixed")
    cfg, params = jload("gazebo_mpc")
    cfg = dataclasses.replace(cfg, **over)
    tcfg, tparams = load_profile("gazebo_mpc", device=CPU)
    tcfg = dataclasses.replace(tcfg, **over)
    tpb = broadcast_batch(tparams, 1)
    tterr = tterrain.Terrain.flat(1, device=CPU)
    n, walk_after, every = 800, 400, 37
    tjoy = tcl.joy_schedule(n, walk_after=walk_after, velx=0.3, device=CPU)
    jjoy = jcl.joy_schedule(n, walk_after=walk_after, velx=0.3)
    shapes = jax.eval_shape(lambda key: jbatched.make_flat_batch(
        cfg, key, 1, params), jax.random.PRNGKey(0))
    first = lambda tree: jtu.tree_map(lambda a: a[0], tree)
    jpb = first(to_jax(shapes[0], tpb))
    dt = jnp.float32(cfg.control_dt)
    jstep = jax.jit(lambda c, j: jtick(
        cfg, jpb, c.cs, c.mem,
        jplant.read_sensors(jpb, c.ps, c.prev_root_lin_vel, dt), j, dt))
    carry = tcl.make_standing_start(tcfg, tpb, tterr, device=CPU)
    tdt = torch.full((), tcfg.control_dt)
    devs, gaps = [], []
    for t in range(n):
        before = carry
        carry, _ = tcl.rollout(tcfg, tpb, tterr, carry,
                               tree_map(lambda a: a[t:t + 1], tjoy), 1,
                               device=CPU)
        if t < walk_after or (t - walk_after) % every:
            continue
        qp = [v[0].double().numpy()
              for v in golden.rebuild_mpc_qp(tcfg, tpb, carry.cs, tdt)]
        x64, _, _, _ = qp_ref.solve_qp_ref(*qp, eps=golden.REF_EPS)
        f_ours = golden._world_forces(carry.cs)[0].numpy()
        devs.append(np.abs(f_ours - x64[:12].reshape(4, 3)).max())
        jcs, _, _ = jstep(first(to_jax(shapes[2], before)),
                          jtu.tree_map(lambda a: a[t], jjoy))
        f_jax = (np.asarray(jcs.root_rot_mat, np.float64)
                 @ np.asarray(jcs.foot_forces_grf, np.float64).T).T
        gaps.append(np.abs(f_ours - f_jax).max())
    devs = np.array(devs)
    assert len(devs) == 11 and np.isfinite(devs).all()
    assert not torch.isnan(carry.ps.root_pos).any()
    assert np.percentile(devs, 95) < 10.0
    assert devs.max() < 20.0
    assert max(gaps) < FIXED_TICK_F_TOL, gaps


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_stand_gate_both_modes(mode):
    """``tests/test_golden.py``'s stand-QP protocol and limits."""
    rep = golden.run_gate(seconds=1.5, sample_every=43, verbose=False,
                          profile="gazebo_qp", solver_mode=mode,
                          mpc_iters=50, device=CPU)
    assert not rep["nan"], mode
    assert rep["frac_within_tol"] == 1.0, (mode, rep)
    assert rep["max_dev_N"] < 1.5, (mode, rep)
