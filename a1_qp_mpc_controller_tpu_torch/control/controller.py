"""The control tick over a batch (counterpart of ``control/controller.py``):
``control_tick``, the whole tick with its own solve (the JAX package's
``control_tick`` under ``vmap``), and the split tick the batched executor
(parallel/batched.py) runs: ``control_tick_build``, everything before
the MPC solve, and ``control_tick_finish``, applying an externally
computed solution."""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.config import A1Config, RobotParams
from a1_qp_mpc_controller_tpu_torch.control import fsm, gait, grf, swing, torque
from a1_qp_mpc_controller_tpu_torch.control.ingest import ingest_sensors
from a1_qp_mpc_controller_tpu_torch.models import estimator
from a1_qp_mpc_controller_tpu_torch.types import (
    CtrlMem, CtrlState, JoyCmd, SensorData,
)


def _sense_and_plan(cfg: A1Config, params: RobotParams, cs: CtrlState,
                    mem: CtrlMem, sensors: SensorData, joy: JoyCmd,
                    dt: torch.Tensor):
    """ingest -> FSM -> gait -> swing -> EKF; returns (cs, mem)."""
    cs, mem = ingest_sensors(cfg, params, cs, mem, sensors)
    if not cfg.use_estimator:
        cs = cs.replace(root_pos=sensors.root_pos,
                        root_lin_vel=sensors.root_lin_vel)
    cs = fsm.joystick_update(cfg, params, cs, joy, dt)
    cs = gait.update_plan(cfg, params, cs, dt)
    cs, mem = swing.generate_swing_legs_ctrl(cfg, params, cs, mem, dt)
    if cfg.use_estimator:
        ekf, cs = estimator.step(cfg, params, cs, mem.ekf, dt)
        mem = mem.replace(ekf=ekf)
    return cs, mem


def control_tick(cfg: A1Config, params: RobotParams, cs: CtrlState,
                 mem: CtrlMem, sensors: SensorData, joy: JoyCmd,
                 dt: torch.Tensor):
    """The full control step of each scenario: sense and plan, the GRF
    solve (``grf.compute_grf``), joint torques. Returns (cs, mem,
    (B, 12) torques)."""
    cs, mem = _sense_and_plan(cfg, params, cs, mem, sensors, joy, dt)
    cs, mem = grf.compute_grf(cfg, params, cs, mem, dt)
    cs, mem = torque.compute_joint_torques(cfg, params, cs, mem)
    return cs, mem, cs.joint_torques


def control_tick_build(cfg: A1Config, params: RobotParams, cs: CtrlState,
                       mem: CtrlMem, sensors: SensorData, joy: JoyCmd,
                       dt: torch.Tensor, with_a_mat: bool = False):
    """ingest -> FSM -> gait -> swing -> EKF -> terrain adaptation ->
    condensed MPC QP; returns (cs, mem, MpcProblem). MPC profiles only.
    ``with_a_mat`` materializes the per-scenario constraint matrix (the
    legacy solve reads it; the shared-basis solve does not)."""
    assert cfg.stance_leg_control_type == 1, "split tick is MPC-only"
    cs, mem = _sense_and_plan(cfg, params, cs, mem, sensors, joy, dt)
    cs, mem = grf.terrain_adaptation(cfg, cs, mem)
    prob = grf.mpc_problem(cfg, params, cs, mem, dt,
                           with_a_mat=with_a_mat)
    return cs, mem, prob


def control_tick_finish(cfg: A1Config, params: RobotParams, cs: CtrlState,
                        mem: CtrlMem, sol):
    """Apply an MPC solution and map torques; returns (cs, mem, (B,12))."""
    cs, mem = grf.mpc_apply_solution(cfg, cs, mem, sol)
    cs, mem = torque.compute_joint_torques(cfg, params, cs, mem)
    return cs, mem, cs.joint_torques
