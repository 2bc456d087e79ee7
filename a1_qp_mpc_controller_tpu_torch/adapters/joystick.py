"""Joystick message semantics shared by all three platforms (counterpart
of ``adapters/joystick.py``).

Parity with the identical joy_callback in each reference adapter
(GazeboA1ROS.cpp:383-409, HardwareA1ROS.cpp / IsaacA1ROS.cpp:274-300) and
the change-request handling at the top of main_update
(GazeboA1ROS.cpp:124-140):

- axes are scaled by the JOY_CMD_* limits (A1Params.h:16-23):
  axes[1] -> body height rate, axes[5] -> velx, axes[2] -> vely,
  axes[0] -> yaw rate, axes[7] -> pitch rate, axes[6] -> roll rate;
- button A (buttons[0]) posts a *state-change request* which main_update
  consumes by toggling stand <-> walk ((ctrl_state + 1) % 2);
- button LB (buttons[4]) latches the exit kill switch.

The toggle/latch state lives in a small JoyState so the mapping is a pure
function (the reference keeps these as adapter member variables mutated
by the callback thread). One joystick drives the whole batch: the state
and the command are 0-d tensors, as ``types.JoyCmd`` is.
"""

from __future__ import annotations

from typing import Tuple

import torch

from a1_qp_mpc_controller_tpu_torch.config import (
    JOY_CMD_BODY_HEIGHT_VEL, JOY_CMD_PITCH_MAX, JOY_CMD_ROLL_MAX,
    JOY_CMD_VELX_MAX, JOY_CMD_VELY_MAX, JOY_CMD_YAW_MAX,
)
from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, resolve_device, tensorclass,
)
from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

AXIS_HEIGHT = 1   # left stick up/down
AXIS_VELX = 5     # right stick up/down
AXIS_VELY = 2     # right stick left/right
AXIS_YAW = 0      # left stick left/right
AXIS_PITCH = 7    # d-pad up/down
AXIS_ROLL = 6     # d-pad left/right
BUTTON_A = 0
BUTTON_LB = 4


@tensorclass
class JoyState:
    """Toggle/latch memory (the reference's joy_cmd_ctrl_state /
    joy_cmd_exit adapter members)."""

    ctrl_state: torch.Tensor       # () int32: 0 stand, 1 walk
    prev_request: torch.Tensor     # () bool: button A held last frame
    exit: torch.Tensor             # () bool latch

    @classmethod
    def init(cls, device=CUDA) -> "JoyState":
        device = resolve_device(device)
        return cls(ctrl_state=torch.zeros((), dtype=torch.int32,
                                          device=device),
                   prev_request=torch.zeros((), dtype=torch.bool,
                                            device=device),
                   exit=torch.zeros((), dtype=torch.bool, device=device))


def map_joy(state: JoyState, axes: torch.Tensor, buttons: torch.Tensor
            ) -> Tuple[JoyState, JoyCmd]:
    """Map one sensor_msgs/Joy-shaped frame (axes (8,), buttons (>=5,), on
    the state's device) to a JoyCmd. Button A toggles stand/walk on the
    rising edge (the reference sets a request flag in the callback and
    consumes it in main_update, GazeboA1ROS.cpp:133-140: a held button
    toggles once); LB latches exit (GazeboA1ROS.cpp:404-408)."""
    axes = axes.to(torch.float32)
    pressed_a = buttons[BUTTON_A] > 0
    rising = pressed_a & ~state.prev_request
    ctrl_state = torch.where(rising, (state.ctrl_state + 1) % 2,
                             state.ctrl_state).to(torch.int32)
    exit_latch = state.exit | (buttons[BUTTON_LB] > 0)

    cmd = JoyCmd(
        velx=axes[AXIS_VELX] * JOY_CMD_VELX_MAX,
        vely=axes[AXIS_VELY] * JOY_CMD_VELY_MAX,
        velz=axes[AXIS_HEIGHT] * JOY_CMD_BODY_HEIGHT_VEL,
        roll_rate=axes[AXIS_ROLL] * JOY_CMD_ROLL_MAX,
        pitch_rate=axes[AXIS_PITCH] * JOY_CMD_PITCH_MAX,
        yaw_rate=axes[AXIS_YAW] * JOY_CMD_YAW_MAX,
        ctrl_state=ctrl_state,
        exit=exit_latch,
    )
    return JoyState(ctrl_state=ctrl_state, prev_request=pressed_a,
                    exit=exit_latch), cmd
