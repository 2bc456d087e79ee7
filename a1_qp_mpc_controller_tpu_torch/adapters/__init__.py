"""Platform adapters: Gazebo, Hardware (Unitree SDK wire), Isaac
(counterpart of ``adapters/``).

The functional re-design of the reference's three adapter classes
(GazeboA1ROS / HardwareA1ROS / IsaacA1ROS, SURVEY.md §2 rows 10-12).
Each adapter is a pair of pure functions around the platform's native
message shapes:

    ingest:  platform raw state  -> SensorData (controller order/frames)
    egress:  joint torques (+cs) -> platform command struct

plus the shared joystick semantics (``adapters.joystick``): raw axes /
buttons -> JoyCmd with the reference's toggle-on-A / latch-on-LB logic.

The control core itself is platform-agnostic: adapters only reorder,
filter and format. Every message type carries a leading batch axis B, as
the port's other state does (the JAX package's are unbatched and
``vmap``-ed); the joystick's state and command are one for the whole
batch (0-d tensors).
"""

from a1_qp_mpc_controller_tpu_torch.adapters import (  # noqa: F401
    gazebo, hardware, isaac, joystick,
)
