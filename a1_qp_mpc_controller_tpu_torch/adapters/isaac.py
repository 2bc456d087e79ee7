"""Isaac Sim adapter (counterpart of ``adapters/isaac.py``): aggregated
JointState + ground-truth PoseStamped. Batched over scenarios.

Parity with IsaacA1ROS (IsaacA1ROS.{h,cpp}):

- ONE aggregated joint-state message: position[0:12] / velocity[0:12] are
  the joints (already in controller order FL,FR,RL,RR), effort[12:16] are
  the foot forces and position[12:16] carry Isaac's binary contact flags
  (IsaacA1ROS.cpp:243-272);
- ground truth arrives as a PoseStamped with BOTH orientation and
  position (IsaacA1ROS.cpp:183-191): unlike Gazebo, the position IS
  consumed (the reference's isaac configs use the EKF for velocity but
  trust the gt position feed);
- egress: a single JointState whose effort vector is the 12 torques
  (IsaacA1ROS.cpp:164-180).
"""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.tensors import tensorclass
from a1_qp_mpc_controller_tpu_torch.types import SensorData


@tensorclass
class IsaacRawState:
    """One aggregated Isaac frame a scenario (IsaacA1ROS.cpp:243-272 + gt
    pose)."""

    joint_q: torch.Tensor        # (B,12) controller order
    joint_dq: torch.Tensor       # (B,12)
    foot_force: torch.Tensor     # (B,4) effort[12:16]
    contact_flag: torch.Tensor   # (B,4) position[12:16], Isaac's contacts
    gt_quat: torch.Tensor        # (B,4) w,x,y,z
    gt_pos: torch.Tensor         # (B,3)
    imu_acc: torch.Tensor        # (B,3)
    imu_gyro: torch.Tensor       # (B,3)


def ingest(raw: IsaacRawState, root_lin_vel: torch.Tensor) -> SensorData:
    """Aggregated frame -> SensorData. ``root_lin_vel`` (B, 3) is the
    velocity feed to pair with the gt position (Isaac publishes no twist;
    the reference pairs gt position with EKF velocity: pass the
    estimator's current velocity, or a gt velocity in pure gt-pose
    mode)."""
    return SensorData(
        root_quat=raw.gt_quat,
        root_pos=raw.gt_pos,
        root_lin_vel=root_lin_vel,
        imu_acc=raw.imu_acc,
        imu_ang_vel=raw.imu_gyro,
        joint_pos=raw.joint_q,
        joint_vel=raw.joint_dq,
        foot_force=raw.foot_force,
    )


@tensorclass
class JointStateCmd:
    """sensor_msgs/JointState-shaped effort command
    (IsaacA1ROS.cpp:164-180)."""

    effort: torch.Tensor  # (B,12)


def egress(joint_torques: torch.Tensor) -> JointStateCmd:
    return JointStateCmd(effort=joint_torques)
