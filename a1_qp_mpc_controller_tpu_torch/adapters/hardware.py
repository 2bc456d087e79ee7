"""Hardware adapter (counterpart of ``adapters/hardware.py``): the Unitree
SDK LowState/LowCmd message contents. Batched over scenarios.

Parity with HardwareA1ROS (HardwareA1ROS.{h,cpp}):

- the wire orders legs FR,FL,RR,RL; the controller orders FL,FR,RL,RR.
  Joints swap via (3,4,5,0,1,2,9,10,11,6,7,8) and feet via (1,0,3,2)
  (HardwareA1ROS.cpp:78-79); both are involutions, so the same mapping
  serves ingest and egress;
- foot forces are smoothed with a per-foot 5-sample ring-buffer average
  (FOOT_FILTER_WINDOW_SIZE, HardwareA1ROS.h:42, HardwareA1ROS.cpp:293-304);
- root position/velocity are never filled from the wire
  (HardwareA1ROS.cpp:272-273): the EKF estimates them (in the reference
  the EKF runs inside this 500 Hz receive path, HardwareA1ROS.cpp:336-341;
  here ``runtime.realtime`` and ``runtime.wire`` give the same dual-rate
  schedule);
- egress: LOWLEVEL LowCmd, servo mode 0x0A, position/velocity control shut
  off (PosStopF/VelStopF), torque-only, reordered to wire order, after the
  PositionLimit/PowerProtect safety filters (HardwareA1ROS.cpp:177-197),
  whose torque-mode analogs live in control/safety.py.
"""

from __future__ import annotations

from typing import Tuple

import torch

from a1_qp_mpc_controller_tpu_torch.config import NUM_LEG
from a1_qp_mpc_controller_tpu_torch.control import safety
from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, resolve_device, tensorclass,
)
from a1_qp_mpc_controller_tpu_torch.types import SensorData
from a1_qp_mpc_controller_tpu_torch.utils.filters import (
    WindowFilter, filter_update, make_filter,
)

# wire <-> controller index maps (involutions), HardwareA1ROS.cpp:78-79
SWAP_JOINT_INDICES = safety.SWAP_JOINT_INDICES
SWAP_FOOT_INDICES = (1, 0, 3, 2)

FOOT_FILTER_WINDOW_SIZE = 5   # HardwareA1ROS.h:42

MOTOR_MODE_SERVO = 0x0A
POS_STOP_F = 2.146e9          # UNITREE_LEGGED_SDK::PosStopF
VEL_STOP_F = 16000.0          # UNITREE_LEGGED_SDK::VelStopF


@tensorclass
class LowState:
    """The subset of UNITREE_LEGGED_SDK::LowState the reference reads
    (HardwareA1ROS.cpp:262-305). Arrays are in WIRE order."""

    imu_quat: torch.Tensor       # (B,4) w,x,y,z
    imu_gyro: torch.Tensor       # (B,3)
    imu_acc: torch.Tensor        # (B,3)
    motor_q: torch.Tensor        # (B,12) wire order
    motor_dq: torch.Tensor       # (B,12) wire order
    foot_force: torch.Tensor     # (B,4) wire order


def make_foot_force_filter(batch: int, dtype=torch.float32,
                           device=CUDA) -> WindowFilter:
    """Each scenario's per-foot 5-sample moving average
    (HardwareA1ROS.cpp:293-304). NOTE the reference divides by the full
    window size even while the ring is still filling; ``filter_update``
    divides by the sample count: the steady-state behavior (after 5
    frames, ~10 ms) is identical."""
    return make_filter((batch,), (NUM_LEG,), FOOT_FILTER_WINDOW_SIZE, dtype,
                       resolve_device(device))


def ingest(state: LowState, foot_filter: WindowFilter
           ) -> Tuple[SensorData, WindowFilter]:
    """LowState (wire order) -> SensorData (controller order) + updated
    foot-force filter. Mirrors receive_low_state's data path
    (HardwareA1ROS.cpp:262-305) minus the inlined EKF, which the runtime
    schedules explicitly."""
    joint_pos = state.motor_q[:, list(SWAP_JOINT_INDICES)]
    joint_vel = state.motor_dq[:, list(SWAP_JOINT_INDICES)]
    raw_force = state.foot_force[:, list(SWAP_FOOT_INDICES)]
    foot_filter, force_avg = filter_update(foot_filter, raw_force)
    z3 = lambda: torch.zeros_like(state.imu_acc)
    return SensorData(
        root_quat=state.imu_quat,
        root_pos=z3(),              # never filled from the wire
        root_lin_vel=z3(),
        imu_acc=state.imu_acc,
        imu_ang_vel=state.imu_gyro,
        joint_pos=joint_pos,
        joint_vel=joint_vel,
        foot_force=force_avg,
    ), foot_filter


@tensorclass
class LowCmd:
    """The torque-only LOWLEVEL command (HardwareA1ROS.cpp:177-193).
    Arrays are in WIRE order."""

    mode: torch.Tensor  # (B,12) int32, 0x0A servo
    q: torch.Tensor     # (B,12) PosStopF: position control off
    dq: torch.Tensor    # (B,12) VelStopF: velocity control off
    kp: torch.Tensor    # (B,12) zero
    kd: torch.Tensor    # (B,12) zero
    tau: torch.Tensor   # (B,12)


def egress(joint_torques: torch.Tensor, joint_pos: torch.Tensor,
           joint_vel: torch.Tensor, power_level: int = 5) -> LowCmd:
    """Controller torques (B, 12) -> safety-filtered wire-order LowCmd.

    Safety runs in controller order (limits are defined per controller
    joint), then the result is reordered for the wire: equivalent to the
    reference's reorder-then-Safety because the SDK's checks are
    per-joint."""
    tau = safety.apply_all(joint_torques, joint_pos, joint_vel, power_level)
    full = lambda v: torch.full(joint_torques.shape, v,
                                dtype=joint_torques.dtype,
                                device=joint_torques.device)
    return LowCmd(
        mode=torch.full(joint_torques.shape, MOTOR_MODE_SERVO,
                        dtype=torch.int32, device=joint_torques.device),
        q=full(POS_STOP_F),
        dq=full(VEL_STOP_F),
        kp=full(0.0),
        kd=full(0.0),
        tau=safety.reorder_for_wire(tau),
    )
