"""The port's hardware transport against the JAX package's
(``runtime/wire.py``, ``runtime/sdk_wire.py``):

- the native and the SDK packers give the JAX functions' bytes on seeded
  inputs (the SDK LowState's rpy field, each package's own float32
  ``quat_to_euler``, within 2 ulp, and with it the CRC over those bytes),
  and the unpackers round-trip them (one scenario, on the CPU);
- the CRC table equals the bitwise CRC and the JAX table;
- the bad-magic, bad-size and bad-CRC rejections of
  ``tests/test_wire.py``;
- the handshake's zero-torque burst in both formats, and a 0.2 s
  closed-loop stand on the port under the JAX test's assertions (100
  frames, 80 ticks, no NaN, 0.2 < z < 0.4).

Under ``slow``: the JAX test's 1.0 s native and 0.5 s SDK runs, on the
port and on the JAX package, each against its own mock robot on the same
wire format; their assertions on both, and the first 5 commands the
mocks decode after the handshake within ``torch_parity.
trot_ticks_match``'s 5e-3 N m.
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu.adapters import hardware as jhw
from a1_qp_mpc_controller_tpu.config import load_profile as jload
from a1_qp_mpc_controller_tpu.runtime import sdk_wire as jsw
from a1_qp_mpc_controller_tpu.runtime import wire as jwire
from a1_qp_mpc_controller_tpu.sim import terrain as jterrain
from a1_qp_mpc_controller_tpu.types import JoyCmd as JJoy
from a1_qp_mpc_controller_tpu_torch.adapters import hardware as hw
from a1_qp_mpc_controller_tpu_torch.config import load_profile
from a1_qp_mpc_controller_tpu_torch.control import safety
from a1_qp_mpc_controller_tpu_torch.runtime import sdk_wire as sw
from a1_qp_mpc_controller_tpu_torch.runtime import wire
from a1_qp_mpc_controller_tpu_torch.sim import terrain as tterrain
from a1_qp_mpc_controller_tpu_torch.tensors import broadcast_batch
from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

from torch_parity import CPU

FORMATS = ("native", "sdk")
CMD_TOL = 5e-3      # N m, torch_parity.trot_ticks_match's torque limit
N_HANDSHAKE = 5
# the SDK LowState's IMU rpy[3] (bytes 40-52 of the IMU struct) is each
# package's own float32 quat_to_euler: PyTorch's atan2 / asin and XLA's
# differ by up to 2 ulp (measured over 200,000 random unit quaternions)
RPY = slice(sw._HEAD.size + 40, sw._HEAD.size + 52)
RPY_ULPS = 2


def _state_inputs(seed):
    """quat, gyro, acc, q, dq, foot: float32, the quaternion unit-norm,
    the foot forces in Newtons (the SDK stores int16 counts)."""
    rng = np.random.default_rng(seed)
    quat = rng.standard_normal(4).astype(np.float32)
    quat /= np.linalg.norm(quat)
    n = lambda k: rng.standard_normal(k).astype(np.float32)
    foot = (rng.uniform(-50.0, 400.0, 4)).astype(np.float32)
    return quat, n(3), n(3), n(12), n(12), foot


def _cmds(seed):
    """The same torques through both packages' egress (power level 5,
    random joint state): (port LowCmd of one scenario, JAX LowCmd)."""
    rng = np.random.default_rng(seed)
    tau, qpos, qvel = (rng.uniform(-40.0, 40.0, 12).astype(np.float32),
                       rng.uniform(-1.0, 1.0, 12).astype(np.float32),
                       rng.uniform(-3.0, 3.0, 12).astype(np.float32))
    t = lambda a: torch.tensor(a[None])
    return (hw.egress(t(tau), t(qpos), t(qvel)),
            jhw.egress(jnp.asarray(tau), jnp.asarray(qpos),
                       jnp.asarray(qvel)))


@pytest.mark.parametrize("seed", range(4))
def test_state_bytes_match_jax(seed):
    args = _state_inputs(seed)
    # the port's packers take tensors as well as arrays
    targs = [torch.tensor(a) for a in args]
    ours = wire.pack_low_state(seed + 3, *targs)
    assert ours == jwire.pack_low_state(seed + 3, *args)
    assert wire.pack_low_state(seed + 3, *args) == ours

    ours = sw.pack_low_state_sdk(seed + 3, *targs)
    ref = jsw.pack_low_state_sdk(seed + 3, *args)
    assert len(ours) == len(ref) == sw.LOW_STATE_SIZE
    assert ours[:RPY.start] == ref[:RPY.start]
    assert ours[RPY.stop:-4] == ref[RPY.stop:-4]
    ulps = np.abs(np.frombuffer(ours[RPY], "<i4").astype(np.int64)
                  - np.frombuffer(ref[RPY], "<i4"))
    assert ulps.max() <= RPY_ULPS, ulps
    # the CRC is Unitree's over the port's bytes: the JAX decoder takes
    # them, and they equal the JAX bytes where the rpy does
    tick, ls = jsw.unpack_low_state_sdk(ours)
    assert tick == seed + 3
    np.testing.assert_array_equal(np.asarray(ls.motor_q), args[3])
    if ulps.max() == 0:
        assert ours == ref


@pytest.mark.parametrize("seed", range(4))
def test_cmd_bytes_match_jax(seed):
    cmd, jcmd = _cmds(seed)
    for pack, jpack in ((wire.pack_low_cmd, jwire.pack_low_cmd),
                        (sw.pack_low_cmd_sdk, jsw.pack_low_cmd_sdk)):
        assert pack(seed, cmd) == jpack(seed, jcmd), pack.__name__


@pytest.mark.parametrize("fmt", FORMATS)
def test_unpack_roundtrips(fmt):
    pack_s, unpack_s, pack_c, unpack_c = wire.wire_functions(fmt)
    quat, gyro, acc, q, dq, foot = _state_inputs(7)
    seq, ls = unpack_s(pack_s(77, quat, gyro, acc, q, dq, foot), device=CPU)
    assert seq == 77
    assert isinstance(ls, hw.LowState) and ls.motor_q.shape == (1, 12)
    exp_foot = np.round(foot) if fmt == "sdk" else foot   # int16 counts
    for got, want in ((ls.imu_quat, quat), (ls.imu_gyro, gyro),
                      (ls.imu_acc, acc), (ls.motor_q, q),
                      (ls.motor_dq, dq), (ls.foot_force, exp_foot)):
        np.testing.assert_array_equal(got[0].numpy(), want)
    cmd, _ = _cmds(7)
    seq, tau = unpack_c(pack_c(9, cmd))
    assert seq == 9
    np.testing.assert_array_equal(tau, cmd.tau[0].numpy())
    # the swap is an involution: wire -> controller order recovers the
    # safety-filtered torques
    np.testing.assert_array_equal(tau[list(hw.SWAP_JOINT_INDICES)],
                                  safety.reorder_for_wire(cmd.tau)[0].numpy())


def test_sdk_struct_sizes_and_crc():
    assert (sw._IMU.size, sw._MOTOR_STATE.size, sw._MOTOR_CMD.size) == (
        56, 44, 36)
    assert (sw.LOW_STATE_SIZE, sw.LOW_CMD_SIZE) == (1020, 796)
    assert sw._CRC_TABLE == jsw._CRC_TABLE
    rng = np.random.default_rng(11)
    for n in (1, 7, 199, 254):
        w = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        assert sw.crc32_core(w) == sw._crc32_core_bitwise(w) == \
            jsw.crc32_core(w), n


def test_rejections():
    """The JAX tests' rejections: a tampered byte fails the SDK CRC, a
    short buffer the SDK size check, a wrong magic the native format;
    an unknown format name raises."""
    args = _state_inputs(5)
    cmd, _ = _cmds(5)
    buf = bytearray(sw.pack_low_state_sdk(1, *args))
    buf[100] ^= 0x40
    with pytest.raises(ValueError, match="CRC"):
        sw.unpack_low_state_sdk(bytes(buf), device=CPU)
    cbuf = bytearray(sw.pack_low_cmd_sdk(1, cmd))
    cbuf[20] ^= 0x01
    with pytest.raises(ValueError, match="CRC"):
        sw.unpack_low_cmd_sdk(bytes(cbuf))
    with pytest.raises(ValueError, match="size"):
        sw.unpack_low_state_sdk(bytes(buf[:-1]), device=CPU)
    with pytest.raises(ValueError, match="size"):
        sw.unpack_low_cmd_sdk(bytes(cbuf) + b"\0")
    with pytest.raises(ValueError, match="magic"):
        wire.unpack_low_state(wire.pack_low_cmd(1, cmd), device=CPU)
    with pytest.raises(ValueError, match="magic"):
        wire.unpack_low_cmd(wire.pack_low_state(1, *args))
    with pytest.raises(ValueError, match="unknown wire format"):
        wire.wire_functions("udp")


def _port_loop(fmt):
    cfg, params = load_profile("gazebo_mpc", device=CPU)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=50, mpc_solver_mode="fixed")
    params = broadcast_batch(params, 1)
    mock = wire.MockA1Robot(params, tterrain.Terrain.flat(1, device=CPU),
                            wire_format=fmt, device=CPU)
    runner = wire.HardwareWireRunner(cfg, params, mock.addr,
                                     wire_format=fmt, device=CPU)
    return mock, runner, JoyCmd.zeros(device=CPU)


def _jax_loop(fmt):
    cfg, params = jload("gazebo_mpc")
    cfg = dataclasses.replace(cfg, mpc_qp_iters=50, mpc_solver_mode="fixed")
    mock = jwire.MockA1Robot(params, jterrain.Terrain.flat(),
                             wire_format=fmt)
    runner = jwire.HardwareWireRunner(cfg, params, mock.addr,
                                      wire_format=fmt)
    return mock, runner, JJoy.zeros()


def _handshake_and_run(mock, runner, joy, seconds, n_hs=N_HANDSHAKE):
    """The JAX test's protocol: the handshake served from a thread, its
    zero-torque burst seen by the robot before any control torque, then
    the lock-step run. Returns (report, the torques the mock decoded
    after the handshake)."""
    t = threading.Thread(target=lambda: [mock.serve_once()
                                         for _ in range(n_hs)])
    t.start()
    got = runner.handshake(n_hs)
    t.join(timeout=30)
    assert not t.is_alive()
    assert got == n_hs
    assert mock.zero_torque_cmds == n_hs
    assert not mock.nonzero_seen
    decoded = []
    unpack = mock._unpack_cmd
    mock._unpack_cmd = lambda buf: decoded.append(unpack(buf)) or \
        decoded[-1]
    try:
        rep = runner.run(seconds, joy, mock)
    finally:
        runner.close()
        mock.close()
    return rep, np.array([tau for _, tau in decoded])


def _assert_stand(rep, frames, ticks):
    assert rep["frames"] == frames
    assert rep["ctrl_steps"] == ticks
    assert not rep["nan"]
    assert 0.2 < rep["final_root"][2] < 0.4


@pytest.mark.parametrize("fmt", FORMATS)
def test_handshake_and_short_stand(fmt):
    rep, taus = _handshake_and_run(*_port_loop(fmt), 0.2)
    _assert_stand(rep, 100, 80)
    assert taus.shape == (100, 12) and np.abs(taus).max() > 1.0


@pytest.mark.slow
@pytest.mark.parametrize("fmt,seconds,frames,ticks",
                         [("native", 1.0, 500, 400), ("sdk", 0.5, 250, 200)])
def test_closed_loop_stand_matches_jax(fmt, seconds, frames, ticks):
    rep, taus = _handshake_and_run(*_port_loop(fmt), seconds)
    jrep, jtaus = _handshake_and_run(*_jax_loop(fmt), seconds)
    for r in (rep, jrep):
        _assert_stand(r, frames, ticks)
    np.testing.assert_allclose(taus[:5], jtaus[:5], atol=CMD_TOL)
