"""Hardware wire loop (counterpart of ``runtime/wire.py``): UDP transport
for the LowState/LowCmd exchange.

The reference's hardware path talks to the robot over the Unitree SDK's
UDP link: a zero-torque ``udp_init_send`` handshake at startup
(HardwareA1ROS.cpp:230-243) and then a 500 Hz receive thread ingesting
``LowState`` (HardwareA1ROS.cpp:245-378) while ``send_cmd`` pushes
torque-only ``LowCmd`` packets back (HardwareA1ROS.cpp:177-197). This
module reproduces that transport against a LOOPBACK mock robot backed by
the port's plant.

Wire format ('native'; the SDK's packed struct is ``runtime/sdk_wire.py``,
'sdk'): little-endian, u32 magic + u32 sequence + float32 payload, the
JAX package's bytes.

- LowState payload: quat(4) gyro(3) acc(3) q(12) dq(12) foot_force(4)
  = 38 floats, WIRE leg order (FR,FL,RR,RL).
- LowCmd payload: mode(12) q(12) dq(12) kp(12) kd(12) tau(12)
  = 72 floats, WIRE order.

The runner steps the exchange synchronously (one state per 2 ms of robot
time, control every 2.5 ms); the timing-accurate threaded schedule is
``realtime.RealtimeRunner``'s. This module's job is the WIRE: sockets,
packing, the handshake and the leg reorder round trip. Both endpoints
run one scenario (a batch of one) on their ``device``.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional, Tuple

import numpy as np
import torch

from a1_qp_mpc_controller_tpu_torch.adapters import hardware as hw
from a1_qp_mpc_controller_tpu_torch.config import A1Config, RobotParams
from a1_qp_mpc_controller_tpu_torch.control.controller import (
    control_tick_noest, estimate_step,
)
from a1_qp_mpc_controller_tpu_torch.runtime import sdk_wire
from a1_qp_mpc_controller_tpu_torch.runtime.native import SensorRing
from a1_qp_mpc_controller_tpu_torch.runtime.realtime import (
    SENSOR_FRAME_LEN, pack_sensors, unpack_sensors,
)
from a1_qp_mpc_controller_tpu_torch.sim import plant as plant_mod
from a1_qp_mpc_controller_tpu_torch.sim import terrain as terrain_mod
from a1_qp_mpc_controller_tpu_torch.tensors import CUDA, check_on, const
from a1_qp_mpc_controller_tpu_torch.types import CtrlMem, CtrlState, JoyCmd

STATE_MAGIC = 0xA15E_ED01
CMD_MAGIC = 0xA1C0_FFEE
_HDR = struct.Struct("<II")
STATE_FLOATS = 4 + 3 + 3 + 12 + 12 + 4
CMD_FLOATS = 6 * 12

# wire leg order involution (FL,FR,RL,RR <-> FR,FL,RR,RL)
_SWAP_J = np.asarray(hw.SWAP_JOINT_INDICES)
_SWAP_F = np.asarray(hw.SWAP_FOOT_INDICES)


def pack_low_state(seq: int, quat, gyro, acc, q_wire, dq_wire,
                   foot_wire) -> bytes:
    h = sdk_wire.host
    payload = np.concatenate([h(quat), h(gyro), h(acc), h(q_wire),
                              h(dq_wire), h(foot_wire)])
    if payload.size != STATE_FLOATS:
        raise ValueError(f"LowState payload of {payload.size} floats")
    return _HDR.pack(STATE_MAGIC, seq & 0xFFFFFFFF) + payload.tobytes()


def unpack_low_state(buf: bytes, device=CUDA) -> Tuple[int, hw.LowState]:
    """(seq, LowState of one scenario on ``device``)."""
    magic, seq = _HDR.unpack_from(buf)
    if magic != STATE_MAGIC:
        raise ValueError(f"bad LowState magic {magic:#x}")
    f = np.frombuffer(buf, np.float32, STATE_FLOATS, _HDR.size)
    return seq, sdk_wire.low_state(f[0:4], f[4:7], f[7:10], f[10:22],
                                   f[22:34], f[34:38], device)


def pack_low_cmd(seq: int, cmd: hw.LowCmd) -> bytes:
    """A LowCmd of one scenario (wire order) as bytes."""
    payload = sdk_wire.cmd_host(cmd).ravel()
    return _HDR.pack(CMD_MAGIC, seq & 0xFFFFFFFF) + payload.tobytes()


def unpack_low_cmd(buf: bytes) -> Tuple[int, np.ndarray]:
    """Returns (seq, tau_wire (12,)): the only fields the mock robot
    acts on (mode/q/dq/kp/kd are the constant torque-only settings)."""
    magic, seq = _HDR.unpack_from(buf)
    if magic != CMD_MAGIC:
        raise ValueError(f"bad LowCmd magic {magic:#x}")
    f = np.frombuffer(buf, np.float32, CMD_FLOATS, _HDR.size)
    return seq, f[60:72].copy()


def wire_functions(fmt: str):
    """(pack_state, unpack_state, pack_cmd, unpack_cmd) for a format
    name: 'native' (the float32 frames above) or 'sdk' (Unitree SDK v3.2
    packed structs, ``runtime/sdk_wire.py``)."""
    if fmt == "native":
        return (pack_low_state, unpack_low_state, pack_low_cmd,
                unpack_low_cmd)
    if fmt == "sdk":
        return (sdk_wire.pack_low_state_sdk, sdk_wire.unpack_low_state_sdk,
                sdk_wire.pack_low_cmd_sdk, sdk_wire.unpack_low_cmd_sdk)
    raise ValueError(f"unknown wire format {fmt!r}")


def _one_scenario(params: RobotParams) -> None:
    if params.robot_mass.shape != (1,):
        raise ValueError("the wire endpoints run one scenario: params "
                         f"batched to 1, got {tuple(params.robot_mass.shape)}")


class MockA1Robot:
    """Loopback robot endpoint: receives LowCmd over UDP, advances the
    port's plant by one sensor period per command on ``device``, replies
    with the resulting LowState (wire leg order): the role Gazebo + the
    SDK's onboard side play for the reference. ``params`` and
    ``terrain`` are a batch of one."""

    def __init__(self, params: RobotParams, terrain: terrain_mod.Terrain,
                 sensor_dt: float = 0.002, wire_format: str = "native",
                 device=CUDA):
        _one_scenario(params)
        self.device = check_on(device, params.robot_mass)
        self._pack_state, _, _, self._unpack_cmd = wire_functions(
            wire_format)
        self.params = params
        self.terrain = terrain
        self.sensor_dt = const(sensor_dt, params.robot_mass.dtype,
                               self.device)
        self.ps = plant_mod.init_standing(params, terrain,
                                          device=self.device)
        self.prev_vel = self.ps.root_lin_vel
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(2.0)
        self.addr = self.sock.getsockname()
        self.zero_torque_cmds = 0
        self.nonzero_seen = False
        self.seq = 0

    def serve_once(self) -> None:
        buf, peer = self.sock.recvfrom(4096)
        _, tau_wire = self._unpack_cmd(buf)
        if not self.nonzero_seen:
            if np.abs(tau_wire).max() == 0.0:
                self.zero_torque_cmds += 1
            else:
                self.nonzero_seen = True
        # wire -> controller joint order, drive the plant
        tau_ctrl = torch.as_tensor(tau_wire[_SWAP_J][None],
                                   device=self.device)
        self.prev_vel = self.ps.root_lin_vel
        self.ps = plant_mod.plant_step(self.params, self.terrain, self.ps,
                                       tau_ctrl, self.sensor_dt)
        s = plant_mod.read_sensors(self.params, self.ps, self.prev_vel,
                                   self.sensor_dt)
        # one host copy of the frame; controller order -> wire order
        f = pack_sensors(s)[0]
        self.seq += 1
        self.sock.sendto(
            self._pack_state(self.seq, f[0:4], f[13:16], f[10:13],
                             f[16:28][_SWAP_J], f[28:40][_SWAP_J],
                             f[40:44][_SWAP_F]), peer)

    def close(self) -> None:
        self.sock.close()


class HardwareWireRunner:
    """Controller endpoint of the UDP loop, one scenario on ``device``.

    ``handshake()`` performs the reference's ``udp_init_send``: a burst
    of zero-torque commands that establishes the link before any control
    runs (HardwareA1ROS.cpp:230-243). ``run()`` then drives the
    dual-rate exchange: every received LowState is ingested through
    ``adapters.hardware.ingest``, the native sensor ring and the
    sensor-rate estimator (HardwareA1ROS.cpp:336-341); a control tick
    fires each time the 2.5 ms control period elapses on the robot clock,
    and its torques go back as a safety-filtered LowCmd."""

    def __init__(self, cfg: A1Config, params: RobotParams,
                 robot_addr, sensor_dt: float = 0.002,
                 power_level: int = 5, wire_format: str = "native",
                 device=CUDA):
        _one_scenario(params)
        self.device = check_on(device, params.robot_mass)
        self.cfg = cfg
        self.params = params
        self.robot_addr = robot_addr
        self.sensor_dt = sensor_dt
        self.power_level = power_level
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(2.0)
        self.cs = CtrlState.init(cfg, params, device=self.device)
        self.mem = CtrlMem.init(cfg, params, device=self.device)
        self.foot_filter = hw.make_foot_force_filter(1, device=self.device)
        self.ring = SensorRing(SENSOR_FRAME_LEN)
        (_, self._unpack_state, self._pack_cmd, _) = wire_functions(
            wire_format)
        self.seq = 0
        self.torques = torch.zeros_like(self.cs.joint_torques)

    def _send_cmd(self, torques: torch.Tensor) -> None:
        cmd = hw.egress(torques, self.cs.joint_pos, self.cs.joint_vel,
                        self.power_level)
        self.seq += 1
        self.sock.sendto(self._pack_cmd(self.seq, cmd), self.robot_addr)

    def _recv_state(self) -> Optional[hw.LowState]:
        try:
            buf, _ = self.sock.recvfrom(4096)
        except socket.timeout:
            return None
        _, ls = self._unpack_state(buf, device=self.device)
        return ls

    def handshake(self, n: int = 10) -> int:
        """udp_init_send parity: n zero-torque commands; returns how many
        state replies arrived (link-up check)."""
        got = 0
        zeros = torch.zeros_like(self.torques)
        for _ in range(n):
            self._send_cmd(zeros)
            if self._recv_state() is not None:
                got += 1
        return got

    def run(self, seconds: float, joy: JoyCmd, mock: MockA1Robot) -> dict:
        """Synchronous dual-rate exchange against ``mock`` (served in
        lock-step from this thread: each send triggers
        ``mock.serve_once()``)."""
        n_frames = int(round(seconds / self.sensor_dt))
        ctrl_dt = float(self.cfg.control_dt)
        t_robot = 0.0
        t_next_ctrl = ctrl_dt
        dtype = self.cs.root_pos.dtype
        s_dt = const(self.sensor_dt, dtype, self.device)
        c_dt = const(ctrl_dt, dtype, self.device)
        ctrl_steps = 0
        for _ in range(n_frames):
            self._send_cmd(self.torques)
            mock.serve_once()
            ls = self._recv_state()
            if ls is None:
                continue
            sensors, self.foot_filter = hw.ingest(ls, self.foot_filter)
            # through the native ring (the transport seam the threaded
            # runner uses)
            self.ring.push(pack_sensors(sensors)[0])
            sensors = unpack_sensors(self.ring.pop_latest(),
                                     device=self.device)
            self.cs, self.mem = estimate_step(
                self.cfg, self.params, self.cs, self.mem, sensors, s_dt)
            t_robot += self.sensor_dt
            if t_robot + 1e-9 >= t_next_ctrl:
                self.cs, self.mem, self.torques = control_tick_noest(
                    self.cfg, self.params, self.cs, self.mem, joy, c_dt)
                t_next_ctrl += ctrl_dt
                ctrl_steps += 1
        root = mock.ps.root_pos[0].cpu()
        return {
            "frames": n_frames,
            "ctrl_steps": ctrl_steps,
            "ring_dropped": self.ring.dropped,
            "final_root": root.tolist(),
            "nan": bool(torch.isnan(root).any()),
        }

    def close(self) -> None:
        self.sock.close()
