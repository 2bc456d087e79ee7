"""The port's dual-rate controller and deterministic runtime against the
JAX package (``control/controller.py`` ``estimate_step``,
``merge_estimate_mem``, ``merge_estimate_cs``, ``control_tick_noest``,
``main_step``, ``grf_step``; ``runtime/realtime.py`` ``pack_sensors``,
``unpack_sensors``, ``run_dual_rate_sim``; ``runtime/telemetry.py``;
``runtime/checkpoint.py``):

- each of the six entry points once from ``torch_parity.stood_start``
  (B = 2, the bench schedule, stood up by the port and handed to both),
  in the schedule's order on the first trot tick: ``estimate_step`` on
  the plant's sensors at the 2 ms sensor period (the EKF's root state
  within 1e-5 m and m/s, its covariance within 1e-6 of its scale), both
  merges exactly (a selection of fields), ``control_tick_noest`` on the
  merged estimate, ``main_step`` and ``grf_step`` from the stood state:
  torques within 5e-3 N m and forces within 0.05 N (two ADMM codes of 25
  float32 iterations that sum in other orders;
  ``torch_parity.trot_ticks_match``'s limits), the plan and the contacts
  exactly; the JAX functions vmapped under ``jax.jit``;
- the port's mirror of ``tests/test_runtime.py``'s
  ``test_merge_estimate_cs_preserves_planning_fields``;
- the sensor frame: ``pack_sensors`` then ``unpack_sensors`` bit for bit,
  each field where the JAX frame has it;
- a checkpoint round trip of a ``LoopCarry``, and a rollout of 4 ticks
  against 2, a checkpoint, and 2 more, bit for bit;
- ``summarize_trace`` and ``write_jsonl`` against the JAX functions on
  the same unbatched trace: the same dict and the same lines; on the
  batched trace, the same keys.

The 2 s ``run_dual_rate_sim`` against the JAX one (the asserts of
``tests/test_runtime.py``'s dual-rate test on both) runs under ``slow``.
"""

import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu.config import load_profile as jload
from a1_qp_mpc_controller_tpu.control import controller as jctl
from a1_qp_mpc_controller_tpu.runtime import realtime as jrt
from a1_qp_mpc_controller_tpu.runtime import telemetry as jtel
from a1_qp_mpc_controller_tpu.sim import plant as jplant
from a1_qp_mpc_controller_tpu.sim import terrain as jterrain
from a1_qp_mpc_controller_tpu.types import JoyCmd as JJoy
from a1_qp_mpc_controller_tpu_torch.config import load_profile
from a1_qp_mpc_controller_tpu_torch.control import controller as tctl
from a1_qp_mpc_controller_tpu_torch.runtime import checkpoint, telemetry
from a1_qp_mpc_controller_tpu_torch.runtime import realtime as trt
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as tcl
from a1_qp_mpc_controller_tpu_torch.sim import plant as tplant
from a1_qp_mpc_controller_tpu_torch.sim import terrain as tterrain
from a1_qp_mpc_controller_tpu_torch.tensors import broadcast_batch, tree_map
from a1_qp_mpc_controller_tpu_torch.types import CtrlState, JoyCmd

from torch_parity import CPU, assert_close, stood_start

B = 2
SENSOR_DT = 0.002
EST_TOL = 1e-5          # m, m/s: the EKF's root state
COV_REL = 1e-6          # the EKF's covariance, of its largest entry
TORQUE_TOL = 5e-3       # N m, torch_parity.trot_ticks_match
FORCE_TOL = 0.05        # N, the same
RESCUE = dict(rescue_capacity=2, rescue_iters=150)
# the JAX test's joystick: trot at 0.3 m/s
JOY_VELX = 0.3


@pytest.fixture(scope="module")
def start():
    return stood_start(B, RESCUE)


def _sensors(start):
    """Both packages' sensor frames of the stood plant at the sensor
    period (the port's plant read on each side)."""
    s_dt = jnp.float32(SENSOR_DT)
    c = start["carry"]
    js = jax.jit(jax.vmap(lambda p, ps, v: jplant.read_sensors(
        p, ps, v, s_dt)))(start["pb"], c.ps, c.prev_root_lin_vel)
    tc = start["tcarry"]
    ts = tplant.read_sensors(start["tpb"], tc.ps, tc.prev_root_lin_vel,
                             torch.tensor(SENSOR_DT))
    return js, ts


def _jit(fn, cfg):
    return jax.jit(jax.vmap(lambda *a: fn(cfg, *a),
                            in_axes=(0, 0, 0, None, None)))


def test_estimate_then_noest_tick_matches_jax(start):
    cfg, tcfg = start["cfg"], start["tcfg"]
    c, tc = start["carry"], start["tcarry"]
    js, ts = _sensors(start)
    jcs_e, jmem_e = jax.jit(jax.vmap(
        lambda p, cs, mem, s: jctl.estimate_step(
            cfg, p, cs, mem, s, jnp.float32(SENSOR_DT))))(
        start["pb"], c.cs, c.mem, js)
    tcs_e, tmem_e = tctl.estimate_step(tcfg, start["tpb"], tc.cs, tc.mem, ts,
                                       torch.tensor(SENSOR_DT))
    for field in ("estimated_root_pos", "estimated_root_vel", "root_pos",
                  "root_lin_vel"):
        assert_close(getattr(tcs_e, field), getattr(jcs_e, field),
                     atol=EST_TOL, err_msg=field)
    for field in ("joint_pos", "foot_pos_abs", "root_euler"):
        assert_close(getattr(tcs_e, field), getattr(jcs_e, field),
                     atol=1e-6, err_msg=field)
    cov = np.asarray(jmem_e.ekf.P)
    assert_close(tmem_e.ekf.P, cov, atol=COV_REL * np.abs(cov).max())

    # the estimate published into the control thread's state and memory
    jcs = jctl.merge_estimate_cs(jcs_e, c.cs)
    jmem = jctl.merge_estimate_mem(jmem_e, c.mem)
    tcs = tctl.merge_estimate_cs(tcs_e, tc.cs)
    tmem = tctl.merge_estimate_mem(tmem_e, tc.mem)
    for a, b in ((tcs.root_pos, tcs_e.root_pos), (tcs.j_foot, tcs_e.j_foot),
                 (tcs.gait_counter, tc.cs.gait_counter),
                 (tmem.ekf.P, tmem_e.ekf.P),
                 (tmem.imu_acc_filter.buf, tmem_e.imu_acc_filter.buf),
                 (tmem.tick, tc.mem.tick),
                 (tmem.mpc_warm_x, tc.mem.mpc_warm_x)):
        assert torch.equal(a, b)

    jcs2, _, jtq = _jit(jctl.control_tick_noest, cfg)(
        start["pb"], jcs, jmem, start["trot"], start["dt"])
    tcs2, _, ttq = tctl.control_tick_noest(tcfg, start["tpb"], tcs, tmem,
                                           start["tjoy"],
                                           torch.tensor(cfg.control_dt))
    assert_close(ttq, jtq, atol=TORQUE_TOL)
    assert_close(tcs2.foot_forces_grf, jcs2.foot_forces_grf, atol=FORCE_TOL)
    for field in ("contacts", "plan_contacts", "movement_mode"):
        np.testing.assert_array_equal(getattr(tcs2, field).numpy(),
                                      np.asarray(getattr(jcs2, field)))
    assert np.abs(np.asarray(jtq)).max() > 1.0


def test_main_and_grf_steps_match_jax(start):
    """The two-thread split from the stood state: ``main_step`` (torques
    from the stood tick's forces), then ``grf_step`` on its state."""
    cfg, tcfg = start["cfg"], start["tcfg"]
    c, tc = start["carry"], start["tcarry"]
    dt = jnp.float32(cfg.control_dt)
    js = jax.jit(jax.vmap(lambda p, ps, v: jplant.read_sensors(
        p, ps, v, dt)))(start["pb"], c.ps, c.prev_root_lin_vel)
    ts = tplant.read_sensors(start["tpb"], tc.ps, tc.prev_root_lin_vel,
                             torch.tensor(cfg.control_dt))
    jcs, jmem, jtq = jax.jit(jax.vmap(
        lambda p, cs, mem, s: jctl.main_step(cfg, p, cs, mem, s,
                                             start["trot"], dt)))(
        start["pb"], c.cs, c.mem, js)
    tcs, tmem, ttq = tctl.main_step(tcfg, start["tpb"], tc.cs, tc.mem, ts,
                                    start["tjoy"], torch.tensor(
                                        cfg.control_dt))
    assert_close(ttq, jtq, atol=TORQUE_TOL)
    assert_close(tcs.estimated_root_pos, jcs.estimated_root_pos,
                 atol=EST_TOL)
    np.testing.assert_array_equal(tcs.contacts.numpy(),
                                  np.asarray(jcs.contacts))
    jcs2, _ = jax.jit(jax.vmap(lambda p, cs, mem: jctl.grf_step(
        cfg, p, cs, mem, dt)))(start["pb"], jcs, jmem)
    tcs2, _ = tctl.grf_step(tcfg, start["tpb"], tcs, tmem,
                            torch.tensor(cfg.control_dt))
    assert_close(tcs2.foot_forces_grf, jcs2.foot_forces_grf, atol=FORCE_TOL)
    assert np.abs(np.asarray(jcs2.foot_forces_grf)).max() > 10.0


def test_merge_estimate_cs_preserves_planning_fields():
    """The port's mirror of the JAX test of the same name: the estimate's
    publish takes the estimation's fields and keeps the control thread's
    planning fields."""
    cfg, params = load_profile("gazebo_mpc", device=CPU)
    base = CtrlState.init(cfg, broadcast_batch(params, 1), device=CPU)
    ctrl = base.replace(
        gait_counter=base.gait_counter + 7.0,
        foot_pos_target_rel=base.foot_pos_target_rel + 0.05,
        movement_mode=torch.ones_like(base.movement_mode))
    est = base.replace(
        root_pos=torch.tensor([[0.1, 0.2, 0.31]]),
        root_lin_vel=torch.tensor([[0.3, 0.0, 0.0]]),
        joint_pos=base.joint_pos + 0.01,
        foot_pos_abs=base.foot_pos_abs + 0.02)
    merged = tctl.merge_estimate_cs(est, ctrl)
    assert torch.equal(merged.root_pos, est.root_pos)
    assert torch.equal(merged.joint_pos, est.joint_pos)
    assert torch.equal(merged.foot_pos_abs, est.foot_pos_abs)
    assert torch.equal(merged.gait_counter, ctrl.gait_counter)
    assert torch.equal(merged.foot_pos_target_rel, ctrl.foot_pos_target_rel)
    assert int(merged.movement_mode[0]) == 1


def test_sensor_frame_roundtrip(start):
    js, ts = _sensors(start)
    frame = trt.pack_sensors(ts)
    assert frame.shape == (B, trt.SENSOR_FRAME_LEN) == (B, 44)
    assert frame.dtype == np.float32
    back = trt.unpack_sensors(frame, device=CPU)
    tree_map(lambda a, b: None if torch.equal(a, b) else pytest.fail(
        "unpack_sensors changed a field"), back, ts)
    # each field where the JAX frame has it (one scenario a frame)
    jframe = jrt.pack_sensors(jax.tree_util.tree_map(lambda a: a[0], js))
    np.testing.assert_allclose(frame[0], jframe, atol=1e-6)


def _rollout(tcfg, tpb, tterr, carry, n, t0=0):
    joy = tcl.joy_schedule(t0 + n, walk_after=2, velx=JOY_VELX, device=CPU)
    return tcl.rollout(tcfg, tpb, tterr, carry,
                       tree_map(lambda a: a[t0:], joy), n, device=CPU)


def test_checkpoint_roundtrip_and_resume(start, tmp_path):
    tcfg, tpb, tterr = start["tcfg"], start["tpb"], start["tterr"]
    carry0 = start["tcarry"]
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(path, carry0)
    fresh = tcl.make_standing_start(tcfg, tpb, tterr, device=CPU)
    restored = checkpoint.load(path, fresh)
    assert checkpoint.roundtrip_equal(carry0, restored)
    assert not checkpoint.roundtrip_equal(carry0, fresh)

    full, _ = _rollout(tcfg, tpb, tterr, carry0, 4)
    half, _ = _rollout(tcfg, tpb, tterr, carry0, 2)
    checkpoint.save(path, half)
    resumed, _ = _rollout(tcfg, tpb, tterr, checkpoint.load(path, fresh),
                          2, t0=2)
    assert checkpoint.roundtrip_equal(full, resumed)


def test_telemetry_matches_jax(start):
    tcfg = start["tcfg"]
    _, trace = _rollout(tcfg, start["tpb"], start["tterr"], start["tcarry"],
                        6)
    one = tree_map(lambda a: a[:, 0], trace)      # the unbatched trace
    as_jax = tree_map(lambda a: jnp.asarray(a.numpy()), one)
    assert telemetry.summarize_trace(one) == jtel.summarize_trace(as_jax)
    bufs = io.StringIO(), io.StringIO()
    n = telemetry.write_jsonl(one, bufs[0], every=2)
    assert n == jtel.write_jsonl(as_jax, bufs[1], every=2) == 3
    assert bufs[0].getvalue() == bufs[1].getvalue()
    summary = telemetry.summarize_trace(trace)
    assert summary.keys() == jtel.summarize_trace(as_jax).keys()
    assert summary["ticks"] == 6 and not summary["nan"]
    buf = io.StringIO()
    assert telemetry.write_jsonl(trace, buf, every=5) == 2
    row = json.loads(buf.getvalue().splitlines()[0])
    assert row.keys() == {"t", "pos", "rpy", "fz", "contacts"}
    assert np.shape(row["fz"]) == (B, 4)


@pytest.mark.slow
def test_dual_rate_sim_matches_jax():
    """``tests/test_runtime.py``'s dual-rate protocol (50 fixed
    iterations, 2 s, trot at 0.3 m/s from 1 s) on both packages, its
    asserts on each; the final positions within 0.05 m of each other
    (two float32 trots, 1,800 steps)."""
    cfg, params = jload("gazebo_mpc")
    cfg = dataclasses.replace(cfg, mpc_qp_iters=50, mpc_solver_mode="fixed")
    jrep = jrt.run_dual_rate_sim(
        cfg, params, jterrain.Terrain.flat(), seconds=2.0,
        joy=JJoy.zeros().replace(ctrl_state=jnp.int32(1),
                                 velx=jnp.float32(JOY_VELX)),
        walk_after_s=1.0)
    tcfg, tparams = load_profile("gazebo_mpc", device=CPU)
    tcfg = dataclasses.replace(tcfg, mpc_qp_iters=50,
                               mpc_solver_mode="fixed")
    joy = JoyCmd.zeros(device=CPU)
    joy = joy.replace(ctrl_state=torch.ones_like(joy.ctrl_state),
                      velx=torch.full_like(joy.velx, JOY_VELX))
    trep = trt.run_dual_rate_sim(
        tcfg, broadcast_batch(tparams, 1), tterrain.Terrain.flat(
            1, device=CPU), seconds=2.0, joy=joy, walk_after_s=1.0,
        device=CPU)
    for rep, x, z in ((jrep, jrep["final_x_m"], jrep["final_z_m"]),
                      (trep, trep["final_x_m"][0], trep["final_z_m"][0])):
        assert rep["est_steps"] == 1000 and rep["ctrl_steps"] == 800
        assert not rep["nan"]
        assert 0.2 < z < 0.4 and x > 0.1
    assert abs(trep["final_x_m"][0] - jrep["final_x_m"]) < 0.05
    assert abs(trep["final_z_m"][0] - jrep["final_z_m"]) < 0.05
