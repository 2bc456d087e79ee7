"""Unitree legged SDK v3.2 packed-struct wire layout, LowState/LowCmd
(counterpart of ``runtime/sdk_wire.py``, the same bytes).

The reference's hardware path exchanges raw C structs with the robot
over UDP through the UNITREE_LEGGED_SDK v3.2 (HardwareA1ROS.h:76-79,
CMakeLists.txt:46-47). ``runtime/wire.py``'s own float32 frame format
carries the same information; this module adds the SDK-shaped BYTE
layout so a byte-capture from a real link can be decoded and commands
encoded in place of the SDK.

Layout provenance: reconstructed from the public unitree_legged_sdk
v3.2 ``comm.h`` field declarations, serialized with little-endian
x86-64 natural alignment (the platform the SDK and the reference's
on-robot NUC use). The struct sizes below are regression constants of
THIS layout (field-for-field as declared, natural padding):

- IMU: float quaternion[4], gyroscope[3], accelerometer[3], rpy[3];
  int8 temperature (+3 pad) ................................. 56 B
- MotorState: uint8 mode (+3), float q,dq,ddq,tauEst,q_raw,dq_raw,
  ddq_raw; int8 temperature (+3); uint32 reserve[2] ......... 44 B
- MotorCmd: uint8 mode (+3), float q,dq,tau,Kp,Kd;
  uint32 reserve[3] ......................................... 36 B
- LowState: uint8 levelFlag (+1), uint16 commVersion, uint16
  robotID (+2), uint32 SN, uint8 bandWidth (+3), IMU,
  MotorState[20], int16 footForce[4], int16 footForceEst[4],
  uint32 tick, uint8 wirelessRemote[40], uint32 reserve,
  uint32 crc ................................................ 1020 B
- LowCmd: same header, MotorCmd[20], LED[4] (3 B each), uint8
  wirelessRemote[40], uint32 reserve, uint32 crc ............ 796 B

CRC: Unitree's published ``crc32_core`` (bitwise, polynomial
0x04c11db7, init 0xFFFFFFFF) over the struct's leading uint32 words,
excluding the trailing crc field itself.

Motor index order on the wire is the SDK's (FR,FL,RR,RL legs); the
controller-order swap lives in ``adapters/hardware.py`` as the
reference's swap_joint_indices does (HardwareA1ROS.cpp:78-79).

Packing is NumPy on the host; a message carries one robot, so the
tensors a packer takes are one scenario's ((12,), or a batch of one), and
an unpacked LowState is a batch of one on ``device``.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
import torch

from a1_qp_mpc_controller_tpu_torch.adapters import hardware as hw
from a1_qp_mpc_controller_tpu_torch.tensors import CUDA, resolve_device
from a1_qp_mpc_controller_tpu_torch.utils import mathx

LOWLEVEL = 0xFF                      # levelFlag (SDK LOWLEVEL)
COMM_VERSION = 0x0000
N_MOTOR = 12                         # populated slots of the 20

_IMU = struct.Struct("<4f3f3f3fb3x")                 # 56
_MOTOR_STATE = struct.Struct("<B3x7fb3x2I")          # 44
_MOTOR_CMD = struct.Struct("<B3x5f3I")               # 36
_HEAD = struct.Struct("<BxHHxxIB3x")                 # 16
_STATE_TAIL = struct.Struct("<4h4hI40sII")           # 68
_CMD_TAIL = struct.Struct("<12s40sII")               # 60 (LED[4]+tail)

LOW_STATE_SIZE = _HEAD.size + _IMU.size + 20 * _MOTOR_STATE.size \
    + _STATE_TAIL.size                               # 1020
LOW_CMD_SIZE = _HEAD.size + 20 * _MOTOR_CMD.size + _CMD_TAIL.size  # 796

_POLY = 0x04C11DB7


def host(x, dtype=np.float32) -> np.ndarray:
    """A tensor (on any device) or array-like as a flat NumPy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype).ravel()


def _crc32_core_bitwise(words: np.ndarray) -> int:
    """Unitree's published bitwise CRC over uint32 words (NOT zlib
    crc32), the reference form :func:`crc32_core` is validated against.
    Because (msb ^= poly) then (bit ^= poly) equals the standard
    (msb ^ bit) update, this is exactly the non-reflected CRC-32 (poly
    0x04C11DB7, init 0xFFFFFFFF, no final xor) over each word's bits
    MSB-first."""
    crc = 0xFFFFFFFF
    for data in np.asarray(words, dtype=np.uint32):
        data = int(data)
        xbit = 1 << 31
        for _ in range(32):
            if crc & 0x80000000:
                crc = ((crc << 1) & 0xFFFFFFFF) ^ _POLY
            else:
                crc = (crc << 1) & 0xFFFFFFFF
            if data & xbit:
                crc ^= _POLY
            xbit >>= 1
    return crc


def _make_crc_table() -> list:
    table = []
    for byte in range(256):
        crc = byte << 24
        for _ in range(8):
            crc = (((crc << 1) & 0xFFFFFFFF) ^ _POLY
                   if crc & 0x80000000 else (crc << 1) & 0xFFFFFFFF)
        table.append(crc)
    return table


_CRC_TABLE = _make_crc_table()


def crc32_core(words: np.ndarray) -> int:
    """Table-driven equivalent of Unitree's bitwise word CRC (the bitwise
    loop costs ~1.7 ms a LowState in Python, most of the 2 ms frame
    budget of the 500 Hz link). Processes each word's 4 bytes
    MSB-first."""
    crc = 0xFFFFFFFF
    t = _CRC_TABLE
    for w in np.asarray(words, dtype=np.uint32):
        w = int(w)
        crc = ((crc << 8) & 0xFFFFFFFF) ^ t[(crc >> 24) ^ ((w >> 24) & 0xFF)]
        crc = ((crc << 8) & 0xFFFFFFFF) ^ t[(crc >> 24) ^ ((w >> 16) & 0xFF)]
        crc = ((crc << 8) & 0xFFFFFFFF) ^ t[(crc >> 24) ^ ((w >> 8) & 0xFF)]
        crc = ((crc << 8) & 0xFFFFFFFF) ^ t[(crc >> 24) ^ (w & 0xFF)]
    return crc


def _crc_of(buf: bytes) -> int:
    words = np.frombuffer(buf[:-4], dtype="<u4")
    return crc32_core(words)


def pack_low_state_sdk(tick: int, quat, gyro, acc, q_wire, dq_wire,
                       foot_wire) -> bytes:
    """Serialize a LowState in the SDK byte layout. ``q_wire``/
    ``dq_wire`` are (12,) SDK motor order; ``foot_wire`` (4,) Newtons
    (stored as the SDK's int16 counts)."""
    quat = host(quat)
    rpy = host(mathx.quat_to_euler(torch.from_numpy(quat)))
    head = _HEAD.pack(LOWLEVEL, COMM_VERSION, 0, 0, 0)
    imu = _IMU.pack(*quat.tolist(), *host(gyro).tolist(),
                    *host(acc).tolist(), *rpy.tolist(), 0)
    q = host(q_wire)
    dq = host(dq_wire)
    motors = b"".join(
        _MOTOR_STATE.pack(0x0A, float(q[i]), float(dq[i]), 0.0, 0.0,
                          float(q[i]), float(dq[i]), 0.0, 0, 0, 0)
        if i < N_MOTOR else
        _MOTOR_STATE.pack(0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0)
        for i in range(20))
    ff = np.clip(np.round(host(foot_wire, np.float64)),
                 -32768, 32767).astype(np.int16)
    tail = _STATE_TAIL.pack(*ff.tolist(), *ff.tolist(),
                            tick & 0xFFFFFFFF, b"\x00" * 40, 0, 0)
    buf = head + imu + motors + tail
    if len(buf) != LOW_STATE_SIZE:
        raise ValueError(f"LowState of {len(buf)} bytes")
    return buf[:-4] + struct.pack("<I", _crc_of(buf))


def unpack_low_state_sdk(buf: bytes, device=CUDA
                         ) -> Tuple[int, hw.LowState]:
    """Decode an SDK-layout LowState -> (tick, ``adapters.hardware.
    LowState`` of one scenario on ``device``) with CRC validation."""
    if len(buf) != LOW_STATE_SIZE:
        raise ValueError(f"bad LowState size {len(buf)}")
    (crc,) = struct.unpack_from("<I", buf, LOW_STATE_SIZE - 4)
    if crc != _crc_of(buf):
        raise ValueError("LowState CRC mismatch")
    off = _HEAD.size
    imu = np.asarray(_IMU.unpack_from(buf, off), np.float32)
    off += _IMU.size
    q = np.zeros(12, np.float32)
    dq = np.zeros(12, np.float32)
    for i in range(N_MOTOR):
        ms = _MOTOR_STATE.unpack_from(buf, off + i * _MOTOR_STATE.size)
        q[i], dq[i] = ms[1], ms[2]
    off += 20 * _MOTOR_STATE.size
    tail = _STATE_TAIL.unpack_from(buf, off)
    foot = np.asarray(tail[0:4], np.float32)
    tick = tail[8]
    return tick, low_state(imu[0:4], imu[4:7], imu[7:10], q, dq, foot,
                           device)


def low_state(quat, gyro, acc, q, dq, foot, device) -> hw.LowState:
    """A LowState of one scenario on ``device`` from wire-order arrays
    (one copy to the device)."""
    parts = [np.asarray(a, np.float32).ravel()
             for a in (quat, gyro, acc, q, dq, foot)]
    flat = torch.tensor(np.concatenate(parts)[None],
                        device=resolve_device(device))
    fields, at = [], 0
    for p in parts:
        fields.append(flat[:, at:at + p.size])
        at += p.size
    return hw.LowState(*fields)


def cmd_host(cmd: hw.LowCmd) -> np.ndarray:
    """A LowCmd of one scenario on the host in one copy: (6, 12) float32,
    the rows mode, q, dq, kp, kd, tau (wire order)."""
    if cmd.tau.numel() != N_MOTOR:
        raise ValueError(f"a LowCmd of one scenario, got tau "
                         f"{tuple(cmd.tau.shape)}")
    return torch.stack([cmd.mode.to(torch.float32), cmd.q, cmd.dq, cmd.kp,
                        cmd.kd, cmd.tau]).reshape(6, N_MOTOR).cpu().numpy()


def pack_low_cmd_sdk(tick: int, cmd: hw.LowCmd) -> bytes:
    """Serialize a torque-only LowCmd (``adapters.hardware.LowCmd`` of one
    scenario, wire motor order) in the SDK byte layout."""
    rows = cmd_host(cmd)
    mode = rows[0].astype(np.int32)
    q, dq, kp, kd, tau = rows[1:]
    head = _HEAD.pack(LOWLEVEL, COMM_VERSION, 0, 0, 0)
    motors = b"".join(
        _MOTOR_CMD.pack(int(mode[i]) & 0xFF, float(q[i]), float(dq[i]),
                        float(tau[i]), float(kp[i]), float(kd[i]),
                        0, 0, 0)
        if i < N_MOTOR else
        _MOTOR_CMD.pack(0, 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0, 0)
        for i in range(20))
    tail = _CMD_TAIL.pack(b"\x00" * 12, b"\x00" * 40, tick & 0xFFFFFFFF,
                          0)
    buf = head + motors + tail
    if len(buf) != LOW_CMD_SIZE:
        raise ValueError(f"LowCmd of {len(buf)} bytes")
    return buf[:-4] + struct.pack("<I", _crc_of(buf))


def unpack_low_cmd_sdk(buf: bytes) -> Tuple[int, np.ndarray]:
    """Decode an SDK-layout LowCmd -> (tick, tau_wire (12,)) with CRC
    validation (the mock robot acts on torques only, like the
    reference's torque-only 0x0A servo commands)."""
    if len(buf) != LOW_CMD_SIZE:
        raise ValueError(f"bad LowCmd size {len(buf)}")
    (crc,) = struct.unpack_from("<I", buf, LOW_CMD_SIZE - 4)
    if crc != _crc_of(buf):
        raise ValueError("LowCmd CRC mismatch")
    tau = np.zeros(12, np.float32)
    for i in range(N_MOTOR):
        mc = _MOTOR_CMD.unpack_from(buf,
                                    _HEAD.size + i * _MOTOR_CMD.size)
        tau[i] = mc[3]
    tail = _CMD_TAIL.unpack_from(buf, _HEAD.size + 20 * _MOTOR_CMD.size)
    tick = tail[2]
    return tick, tau
