"""The control tick over a batch (counterpart of ``control/controller.py``):
``control_tick``, the whole tick with its own solve (the JAX package's
``control_tick`` under ``vmap``), on every profile, and the split ticks
the batched executors (parallel/batched.py) run: ``control_tick_build``
/ ``control_tick_build_qp``, everything before the MPC / stand-QP solve,
and ``control_tick_finish`` / ``control_tick_finish_qp``, applying an
externally computed solution. The hardware's dual-rate schedule (the
EKF at the 500 Hz sensor rate, control at 400 Hz): ``estimate_step``,
``merge_estimate_mem``, ``merge_estimate_cs`` and ``control_tick_noest``;
the reference's two-thread split: ``main_step`` and ``grf_step``."""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.config import A1Config, RobotParams
from a1_qp_mpc_controller_tpu_torch.control import fsm, gait, grf, swing, torque
from a1_qp_mpc_controller_tpu_torch.control.ingest import ingest_sensors
from a1_qp_mpc_controller_tpu_torch.models import estimator
from a1_qp_mpc_controller_tpu_torch.types import (
    CtrlMem, CtrlState, JoyCmd, SensorData,
)


def _plan(cfg: A1Config, params: RobotParams, cs: CtrlState, mem: CtrlMem,
          joy: JoyCmd, dt: torch.Tensor):
    """FSM -> gait -> swing; returns (cs, mem)."""
    cs = fsm.joystick_update(cfg, params, cs, joy, dt)
    cs = gait.update_plan(cfg, params, cs, dt)
    return swing.generate_swing_legs_ctrl(cfg, params, cs, mem, dt)


def _sense_and_plan(cfg: A1Config, params: RobotParams, cs: CtrlState,
                    mem: CtrlMem, sensors: SensorData, joy: JoyCmd,
                    dt: torch.Tensor):
    """ingest -> FSM -> gait -> swing -> EKF; returns (cs, mem)."""
    cs, mem = ingest_sensors(cfg, params, cs, mem, sensors)
    if not cfg.use_estimator:
        cs = cs.replace(root_pos=sensors.root_pos,
                        root_lin_vel=sensors.root_lin_vel)
    cs, mem = _plan(cfg, params, cs, mem, joy, dt)
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


def control_tick_build_qp(cfg: A1Config, params: RobotParams, cs: CtrlState,
                          mem: CtrlMem, sensors: SensorData, joy: JoyCmd,
                          dt: torch.Tensor):
    """ingest -> FSM -> gait -> swing -> EKF -> stand QP; returns (cs,
    mem, StandQpProblem). Stand-QP profiles only."""
    assert cfg.stance_leg_control_type == 0, "build_qp is stand-QP-only"
    cs, mem = _sense_and_plan(cfg, params, cs, mem, sensors, joy, dt)
    return cs, mem, grf.stand_qp_problem(cfg, params, cs, mem)


def control_tick_finish_qp(cfg: A1Config, params: RobotParams, cs: CtrlState,
                           mem: CtrlMem, sol):
    """Apply a stand-QP solution and map torques; returns (cs, mem,
    (B,12))."""
    cs, mem = grf.stand_qp_apply(cfg, cs, mem, sol)
    cs, mem = torque.compute_joint_torques(cfg, params, cs, mem)
    return cs, mem, cs.joint_torques


# --- the sensor-rate estimation split (the hardware schedule) -------------
# The reference's hardware stack runs the EKF inside its 500 Hz receive
# thread while control runs at 400 Hz: ``estimate_step`` at the sensor
# rate, ``control_tick_noest`` at the control rate on the latest estimate.

def estimate_step(cfg: A1Config, params: RobotParams, cs: CtrlState,
                  mem: CtrlMem, sensors: SensorData, dt: torch.Tensor):
    """Sensor-rate work: ingest and the EKF, ``dt`` the sensor period.
    Touches only the estimation's memory (the IMU filters and the EKF);
    :func:`merge_estimate_mem` joins it to the control's. Returns (cs,
    mem)."""
    cs, mem = ingest_sensors(cfg, params, cs, mem, sensors)
    if cfg.use_estimator:
        ekf, cs = estimator.step(cfg, params, cs, mem.ekf, dt)
        mem = mem.replace(ekf=ekf)
    else:
        cs = cs.replace(root_pos=sensors.root_pos,
                        root_lin_vel=sensors.root_lin_vel)
    return cs, mem


def merge_estimate_mem(est_mem: CtrlMem, ctrl_mem: CtrlMem) -> CtrlMem:
    """The control's memory with the estimation's fields (the EKF carry
    and the IMU ingest filters) taken from ``est_mem``."""
    return ctrl_mem.replace(ekf=est_mem.ekf,
                            imu_acc_filter=est_mem.imu_acc_filter,
                            imu_gyro_filter=est_mem.imu_gyro_filter)


def merge_estimate_cs(est_cs: CtrlState, ctrl_cs: CtrlState) -> CtrlState:
    """The control's current state with only the estimation's fields
    (ingested sensors, their kinematics, the EKF's root state) taken from
    ``est_cs``: the fields the reference's receive thread writes. The
    planning fields (gait counters, FSM state, swing targets) stay the
    control's, so an update that interleaved the estimate is not lost."""
    return ctrl_cs.replace(
        # ingest_sensors fields
        root_quat=est_cs.root_quat,
        root_rot_mat=est_cs.root_rot_mat,
        root_euler=est_cs.root_euler,
        root_rot_mat_z=est_cs.root_rot_mat_z,
        root_ang_vel=est_cs.root_ang_vel,
        imu_acc=est_cs.imu_acc,
        imu_ang_vel=est_cs.imu_ang_vel,
        joint_pos=est_cs.joint_pos,
        joint_vel=est_cs.joint_vel,
        foot_force=est_cs.foot_force,
        foot_pos_rel=est_cs.foot_pos_rel,
        foot_pos_abs=est_cs.foot_pos_abs,
        foot_pos_world=est_cs.foot_pos_world,
        foot_vel_rel=est_cs.foot_vel_rel,
        foot_vel_abs=est_cs.foot_vel_abs,
        foot_vel_world=est_cs.foot_vel_world,
        j_foot=est_cs.j_foot,
        # estimator.step fields
        estimated_contacts=est_cs.estimated_contacts,
        estimated_root_pos=est_cs.estimated_root_pos,
        estimated_root_vel=est_cs.estimated_root_vel,
        root_pos=est_cs.root_pos,
        root_lin_vel=est_cs.root_lin_vel,
    )


def control_tick_noest(cfg: A1Config, params: RobotParams, cs: CtrlState,
                       mem: CtrlMem, joy: JoyCmd, dt: torch.Tensor):
    """Control-rate work when estimation runs at the sensor rate: FSM,
    plan, swing, the GRF solve, torques, on the latest ingested and
    estimated ``cs`` (no ingest, no EKF). Returns (cs, mem, (B, 12))."""
    cs, mem = _plan(cfg, params, cs, mem, joy, dt)
    cs, mem = grf.compute_grf(cfg, params, cs, mem, dt)
    cs, mem = torque.compute_joint_torques(cfg, params, cs, mem)
    return cs, mem, cs.joint_torques


# --- the reference's two-thread split -------------------------------------

def main_step(cfg: A1Config, params: RobotParams, cs: CtrlState,
              mem: CtrlMem, sensors: SensorData, joy: JoyCmd,
              dt: torch.Tensor):
    """The main thread's work: ingest, FSM, plan, swing, the EKF and
    torques from the latest GRF solution in ``cs.foot_forces_grf``.
    Returns (cs, mem, (B, 12))."""
    cs, mem = ingest_sensors(cfg, params, cs, mem, sensors)
    cs, mem = _plan(cfg, params, cs, mem, joy, dt)
    ekf, cs = estimator.step(cfg, params, cs, mem.ekf, dt)
    mem = mem.replace(ekf=ekf)
    cs, mem = torque.compute_joint_torques(cfg, params, cs, mem)
    return cs, mem, cs.joint_torques


def grf_step(cfg: A1Config, params: RobotParams, cs: CtrlState,
             mem: CtrlMem, dt: torch.Tensor):
    """The GRF thread's work: the stance-force solve. Returns (cs,
    mem)."""
    return grf.compute_grf(cfg, params, cs, mem, dt)
