"""Gazebo adapter (counterpart of ``adapters/gazebo.py``): per-joint
MotorState topics + contact wrenches + ground-truth odometry ->
SensorData; torques -> 12 MotorCmd records. Batched over scenarios.

Parity with GazeboA1ROS (GazeboA1ROS.{h,cpp}):

- 12 separate per-joint MotorState subscriptions carrying (q, dq)
  already in controller order FL,FR,RL,RR (GazeboA1ROS.cpp:303-364);
- 4 foot-contact wrenches: only force.z is read (GazeboA1ROS.cpp:367-381);
- /torso_odom supplies the orientation quaternion; the reference
  deliberately does NOT take position/velocity from it (commented out at
  GazeboA1ROS.cpp:241-247): the EKF estimates them;
- /trunk_imu accel + gyro (smoothed inside the tick's ingest with the
  same 5-tap windows the callbacks use, GazeboA1ROS.cpp:284-300);
- egress: 12 MotorCmd records, torque-only servo mode 0x0A with zero
  position/velocity gains (GazeboA1ROS.cpp:215-232).
"""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.tensors import tensorclass
from a1_qp_mpc_controller_tpu_torch.types import SensorData

MOTOR_MODE_SERVO = 0x0A


@tensorclass
class GazeboRawState:
    """The per-tick snapshot the Gazebo callbacks would have written."""

    joint_q: torch.Tensor        # (B,12) MotorState.q, controller order
    joint_dq: torch.Tensor       # (B,12) MotorState.dq
    foot_wrench_z: torch.Tensor  # (B,4) contact wrench force.z per foot
    odom_quat: torch.Tensor      # (B,4) w,x,y,z from /torso_odom
    imu_acc: torch.Tensor        # (B,3) /trunk_imu linear_acceleration
    imu_gyro: torch.Tensor       # (B,3) /trunk_imu angular_velocity


def ingest(raw: GazeboRawState) -> SensorData:
    """Raw topics -> SensorData. root_pos / root_lin_vel stay zero: the
    reference never feeds them from Gazebo ground truth
    (GazeboA1ROS.cpp:241-247); the EKF owns them."""
    z3 = torch.zeros_like(raw.imu_acc)
    return SensorData(
        root_quat=raw.odom_quat,
        root_pos=z3,
        root_lin_vel=z3.clone(),
        imu_acc=raw.imu_acc,
        imu_ang_vel=raw.imu_gyro,
        joint_pos=raw.joint_q,
        joint_vel=raw.joint_dq,
        foot_force=raw.foot_wrench_z,
    )


@tensorclass
class MotorCmds:
    """12 unitree_legged_msgs/MotorCmd records a scenario
    (array-of-struct layout)."""

    mode: torch.Tensor  # (B,12) int32
    q: torch.Tensor     # (B,12) position target (unused, 0)
    dq: torch.Tensor    # (B,12) velocity target (unused, 0)
    kp: torch.Tensor    # (B,12)
    kd: torch.Tensor    # (B,12)
    tau: torch.Tensor   # (B,12)


def egress(joint_torques: torch.Tensor) -> MotorCmds:
    """Torques (B, 12) -> tau-only MotorCmd records
    (GazeboA1ROS.cpp:221-229)."""
    z = lambda: torch.zeros_like(joint_torques)
    return MotorCmds(
        mode=torch.full(joint_torques.shape, MOTOR_MODE_SERVO,
                        dtype=torch.int32, device=joint_torques.device),
        q=z(), dq=z(), kp=z(), kd=z(), tau=joint_torques,
    )
