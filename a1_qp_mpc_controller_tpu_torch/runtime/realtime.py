"""The hardware's dual-rate schedule, run deterministically (counterpart
of the deterministic part of ``runtime/realtime.py``): ``pack_sensors`` /
``unpack_sensors``, the 44-float sensor frame, and ``run_dual_rate_sim``,
estimation at the 500 Hz sensor rate and control at 400 Hz on a merged
timeline, over a batch of scenarios. The threaded runner waits for the
port's native executor."""

from __future__ import annotations

import numpy as np
import torch

from a1_qp_mpc_controller_tpu_torch.config import A1Config, RobotParams
from a1_qp_mpc_controller_tpu_torch.control.controller import (
    control_tick_noest, estimate_step,
)
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as cl
from a1_qp_mpc_controller_tpu_torch.sim import plant as plant_mod
from a1_qp_mpc_controller_tpu_torch.sim import terrain as terrain_mod
from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, check_on, const, resolve_device,
)
from a1_qp_mpc_controller_tpu_torch.types import JoyCmd, SensorData

# quaternion, position, velocity, IMU acceleration and rate, joint
# positions and velocities, foot forces
_FRAME = (("root_quat", 4), ("root_pos", 3), ("root_lin_vel", 3),
          ("imu_acc", 3), ("imu_ang_vel", 3), ("joint_pos", 12),
          ("joint_vel", 12), ("foot_force", 4))
SENSOR_FRAME_LEN = sum(n for _, n in _FRAME)  # 44 floats


def pack_sensors(s: SensorData) -> np.ndarray:
    """(B, 44) float32 frames of a batch of sensor snapshots."""
    return np.concatenate([getattr(s, name).detach().cpu().numpy()
                           for name, _ in _FRAME], axis=-1
                          ).astype(np.float32)


def unpack_sensors(frame: np.ndarray, device=CUDA) -> SensorData:
    """The sensor snapshots of (B, 44) frames (or one (44,) frame, as a
    batch of one) on ``device``."""
    f = torch.as_tensor(np.asarray(frame, np.float32).reshape(
        -1, SENSOR_FRAME_LEN), device=resolve_device(device))
    fields, at = {}, 0
    for name, n in _FRAME:
        fields[name] = f[:, at:at + n].clone()
        at += n
    return SensorData(**fields)


def run_dual_rate_sim(cfg: A1Config, params: RobotParams,
                      terrain: terrain_mod.Terrain, seconds: float,
                      joy: JoyCmd, sensor_dt: float = 0.002,
                      walk_after_s: float = 0.5, device=CUDA) -> dict:
    """The hardware schedule without threads: every scenario's plant
    steps and its ingest and EKF run at the sensor period (``sensor_dt``,
    the plant on the latest torques), the control tick without the EKF
    at ``cfg.control_dt`` on the latest estimate, ``joy`` (unbatched)
    from ``walk_after_s`` and a standing command before. The events are
    ordered on one timeline, the sensor's first on a tie, as the receive
    thread runs ahead of the control thread. Returns the step counts,
    each scenario's final x and z (lists of B) and whether any position
    or torque is NaN."""
    device = check_on(device, params.robot_mass)
    carry = cl.make_standing_start(cfg, params, terrain, device=device)
    cs, mem, ps = carry.cs, carry.mem, carry.ps
    prev_vel = carry.prev_root_lin_vel
    ctrl_dt = float(cfg.control_dt)
    dtype = ps.root_pos.dtype
    s_dt, c_dt = const(sensor_dt, dtype, device), const(ctrl_dt, dtype,
                                                         device)
    torques = cs.joint_torques
    n_est = int(round(seconds / sensor_dt))
    n_ctrl = int(round(seconds / ctrl_dt))
    events = sorted(
        [(i * sensor_dt, 0, i) for i in range(1, n_est + 1)]
        + [(i * ctrl_dt, 1, i) for i in range(1, n_ctrl + 1)])
    joy_stand = JoyCmd.zeros(device=device)
    est_steps = ctrl_steps = 0
    for t_ev, kind, _ in events:
        if kind == 0:
            sensors = plant_mod.read_sensors(params, ps, prev_vel, s_dt)
            prev_vel = ps.root_lin_vel
            ps = plant_mod.plant_step(params, terrain, ps, torques, s_dt)
            cs, mem = estimate_step(cfg, params, cs, mem, sensors, s_dt)
            est_steps += 1
        else:
            j = joy if t_ev >= walk_after_s else joy_stand
            cs, mem, torques = control_tick_noest(cfg, params, cs, mem, j,
                                                  c_dt)
            ctrl_steps += 1
    root = ps.root_pos.cpu()
    return {
        "est_steps": est_steps,
        "ctrl_steps": ctrl_steps,
        "final_x_m": root[:, 0].tolist(),
        "final_z_m": root[:, 2].tolist(),
        "nan": bool(torch.isnan(root).any()
                    or torch.isnan(torques).any()),
    }
