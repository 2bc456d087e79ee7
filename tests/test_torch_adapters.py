"""The port's platform adapters (``adapters/{gazebo,hardware,isaac,
joystick}.py``) against the JAX package's, vmapped, on B = 3 inputs made
from a NumPy seed: exact for the reorderings, the egress formats and the
joystick's state sequence, the filtered foot forces within 1e-6 N and the
safety-filtered torques within the safety filter's 1e-6 (relative). Each
test of ``tests/test_adapters.py`` has its mirror here on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu.adapters import gazebo as jgz
from a1_qp_mpc_controller_tpu.adapters import hardware as jhw
from a1_qp_mpc_controller_tpu.adapters import isaac as jis
from a1_qp_mpc_controller_tpu.adapters import joystick as jjoy
from a1_qp_mpc_controller_tpu_torch import convert
from a1_qp_mpc_controller_tpu_torch.adapters import (
    gazebo, hardware, isaac, joystick,
)
from a1_qp_mpc_controller_tpu_torch.control import safety

from torch_parity import CPU, assert_tree_close, jax_to_dict

B = 3
FILTER_TOL = 1e-6      # N, the filtered foot forces (a running sum)
SAFETY_REL = 1e-6      # tests/test_torch_stand.py's safety-filter limit


def _rand(seed, **shapes):
    """A dict of float32 arrays (B, *shape) from ``seed``."""
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-2.0, 2.0, (B,) + s).astype(np.float32)
            for k, s in shapes.items()}


def _both(cls, jcls, arrays):
    return (cls(**{k: torch.tensor(v) for k, v in arrays.items()}),
            jcls(**{k: jnp.asarray(v) for k, v in arrays.items()}))


def _exact(port, ref):
    assert_tree_close(port, ref, atol=0.0)


class TestJoystick:
    def _axes(self, **kw):
        a = torch.zeros(8)
        for k, v in kw.items():
            a[getattr(joystick, f"AXIS_{k.upper()}")] = v
        return a

    def test_axis_scaling(self):
        st = joystick.JoyState.init(device=CPU)
        axes = self._axes(velx=1.0, vely=-1.0, yaw=0.5, height=1.0,
                          pitch=-1.0, roll=1.0)
        _, cmd = joystick.map_joy(st, axes,
                                  torch.zeros(11, dtype=torch.int32))
        assert float(cmd.velx) == pytest.approx(0.6)   # JOY_CMD_VELX_MAX
        assert float(cmd.vely) == pytest.approx(-0.3)
        assert float(cmd.yaw_rate) == pytest.approx(0.4)
        assert float(cmd.velz) == pytest.approx(0.04)
        assert float(cmd.pitch_rate) == pytest.approx(-0.4)
        assert float(cmd.roll_rate) == pytest.approx(0.4)
        assert cmd.velx.shape == () and cmd.ctrl_state.dtype == torch.int32

    def test_button_a_toggles_once_per_press(self):
        st = joystick.JoyState.init(device=CPU)
        axes = torch.zeros(8)
        press = torch.zeros(11, dtype=torch.int32)
        press[joystick.BUTTON_A] = 1
        release = torch.zeros(11, dtype=torch.int32)
        st, cmd = joystick.map_joy(st, axes, press)      # 0 -> 1
        assert int(cmd.ctrl_state) == 1
        st, cmd = joystick.map_joy(st, axes, press)      # held: stays 1
        assert int(cmd.ctrl_state) == 1
        st, cmd = joystick.map_joy(st, axes, release)
        st, cmd = joystick.map_joy(st, axes, press)      # toggles back
        assert int(cmd.ctrl_state) == 0

    def test_exit_latches(self):
        st = joystick.JoyState.init(device=CPU)
        lb = torch.zeros(11, dtype=torch.int32)
        lb[joystick.BUTTON_LB] = 1
        st, cmd = joystick.map_joy(st, torch.zeros(8), lb)
        assert bool(cmd.exit)
        st, cmd = joystick.map_joy(st, torch.zeros(8),
                                   torch.zeros(11, dtype=torch.int32))
        assert bool(cmd.exit)  # stays latched

    def test_sequence_matches_jax(self):
        """20 frames of seeded axes and buttons (A held over runs of
        frames, LB late) through both packages' ``map_joy``: every state
        and command the same."""
        rng = np.random.default_rng(3)
        axes = rng.uniform(-1.0, 1.0, (20, 8)).astype(np.float32)
        buttons = (rng.random((20, 11)) < 0.4).astype(np.int32)
        buttons[:12, joystick.BUTTON_LB] = 0
        st, jst = joystick.JoyState.init(device=CPU), jjoy.JoyState.init()
        jmap = jax.jit(jjoy.map_joy)
        for t in range(20):
            st, cmd = joystick.map_joy(st, torch.tensor(axes[t]),
                                       torch.tensor(buttons[t]))
            jst, jcmd = jmap(jst, jnp.asarray(axes[t]),
                             jnp.asarray(buttons[t]))
            _exact(st, jst)
            _exact(cmd, jcmd)
        assert bool(cmd.exit)


class TestHardwareWire:
    def test_swap_is_involution_and_matches_jax(self):
        assert hardware.SWAP_JOINT_INDICES == tuple(
            np.asarray(jhw.SWAP_JOINT_INDICES).tolist())
        assert hardware.SWAP_FOOT_INDICES == tuple(
            np.asarray(jhw.SWAP_FOOT_INDICES).tolist())
        sw, sf = list(hardware.SWAP_JOINT_INDICES), list(
            hardware.SWAP_FOOT_INDICES)
        x, f = torch.arange(12.0), torch.arange(4.0)
        assert torch.equal(x[sw][sw], x) and torch.equal(f[sf][sf], f)

    def test_ingest_reorders_and_filters(self):
        # wire order FR,FL,RR,RL: motor_q = leg index repeated
        motor_q = torch.tensor([1.0, 0.0, 3.0, 2.0]).repeat_interleave(
            3)[None].expand(B, 12)
        state = hardware.LowState(
            imu_quat=torch.tensor([[1.0, 0, 0, 0]]).expand(B, 4),
            imu_gyro=torch.zeros(B, 3), imu_acc=torch.zeros(B, 3),
            motor_q=motor_q, motor_dq=motor_q * 10.0,
            foot_force=torch.tensor([[10.0, 0.0, 30.0, 20.0]]).expand(B, 4))
        filt = hardware.make_foot_force_filter(B, device=CPU)
        sensors, filt = hardware.ingest(state, filt)
        # controller order: leg i has q == i
        np.testing.assert_allclose(sensors.joint_pos.numpy(),
                                   np.tile(np.repeat(np.arange(4.0), 3),
                                           (B, 1)))
        np.testing.assert_allclose(sensors.foot_force.numpy(),
                                   np.tile([0.0, 10.0, 20.0, 30.0], (B, 1)))
        for _ in range(hardware.FOOT_FILTER_WINDOW_SIZE):
            sensors, filt = hardware.ingest(state, filt)
        np.testing.assert_allclose(sensors.foot_force.numpy(),
                                   np.tile([0.0, 10.0, 20.0, 30.0], (B, 1)),
                                   atol=1e-5)

    def test_ingest_matches_jax(self):
        """Eight frames of seeded LowStates through both packages' ingest,
        the filter carried: the reordered fields exactly, the filtered
        foot forces within 1e-6."""
        filt = hardware.make_foot_force_filter(B, device=CPU)
        jfilt = jax.vmap(lambda _: jhw.make_foot_force_filter())(
            jnp.arange(B))
        jingest = jax.jit(jax.vmap(jhw.ingest))
        for frame in range(8):
            arrays = _rand(frame, imu_quat=(4,), imu_gyro=(3,),
                           imu_acc=(3,), motor_q=(12,), motor_dq=(12,),
                           foot_force=(4,))
            arrays["foot_force"] *= 100.0
            state, jstate = _both(hardware.LowState, jhw.LowState, arrays)
            sensors, filt = hardware.ingest(state, filt)
            jsensors, jfilt = jingest(jstate, jfilt)
            assert_tree_close(sensors, jsensors, atol=0.0,
                              skip=("foot_force",))
            np.testing.assert_allclose(sensors.foot_force.numpy(),
                                       np.asarray(jsensors.foot_force),
                                       atol=FILTER_TOL, rtol=0.0)

    @pytest.mark.parametrize("power_level", [1, 5, 10])
    def test_egress_matches_jax(self, power_level):
        """Seeded torques over the limit, joint positions near the limits
        and fast joints: the LowCmd of both packages, the modes, gains and
        stop values exactly; the torques within ``SAFETY_REL`` (the power
        guard's sum over 12 joints, summed in another order; the reorder
        itself is exact, ``test_egress_wire_order_and_modes``)."""
        rng = np.random.default_rng(power_level)
        tau = rng.uniform(-45.0, 45.0, (B, 12)).astype(np.float32)
        lo = np.tile(safety.JOINT_POS_MIN, (B, 1))
        hi = np.tile(safety.JOINT_POS_MAX, (B, 1))
        qpos = rng.uniform(lo - 0.05, hi + 0.05).astype(np.float32)
        qvel = rng.uniform(-20.0, 20.0, (B, 12)).astype(np.float32)
        cmd = hardware.egress(torch.tensor(tau), torch.tensor(qpos),
                              torch.tensor(qvel), power_level)
        jcmd = jax.vmap(
            lambda a, b, c: jhw.egress(a, b, c, power_level))(
            jnp.asarray(tau), jnp.asarray(qpos), jnp.asarray(qvel))
        assert_tree_close(cmd, jcmd, atol=0.0, skip=("tau",))
        np.testing.assert_allclose(cmd.tau.numpy(), np.asarray(jcmd.tau),
                                   rtol=SAFETY_REL, atol=0.0)

    def test_egress_wire_order_and_modes(self):
        tau = (torch.arange(12.0) * 0.1)[None].expand(B, 12)
        qpos, qvel = torch.zeros(B, 12), torch.zeros(B, 12)
        cmd = hardware.egress(tau, qpos, qvel, power_level=10)
        assert torch.all(cmd.mode == 0x0A) and cmd.mode.dtype == torch.int32
        assert torch.all(cmd.kp == 0) and torch.all(cmd.kd == 0)
        # position/velocity control shut off
        assert torch.all(cmd.q == hardware.POS_STOP_F)
        assert torch.all(cmd.dq == hardware.VEL_STOP_F)
        # wire reorder: cmd.tau[wire i] = safe_tau[controller swap_i]
        safe_tau = safety.apply_all(tau, qpos, qvel, 10)
        assert torch.equal(cmd.tau,
                           safe_tau[:, list(hardware.SWAP_JOINT_INDICES)])

    def test_egress_applies_safety(self):
        cmd = hardware.egress(torch.full((B, 12), 100.0),
                              torch.zeros(B, 12), torch.zeros(B, 12),
                              power_level=10)
        assert cmd.tau.abs().max() <= safety.TORQUE_LIMIT

    def test_hardware_ingest_batched(self):
        """The counterpart of the JAX test's jit + vmap: one call over a
        batch of eight, the filter's shapes kept."""
        b = 8
        state = hardware.LowState(
            imu_quat=torch.tensor([[1.0, 0, 0, 0]]).expand(b, 4),
            imu_gyro=torch.zeros(b, 3), imu_acc=torch.zeros(b, 3),
            motor_q=torch.zeros(b, 12), motor_dq=torch.zeros(b, 12),
            foot_force=torch.ones(b, 4))
        filt = hardware.make_foot_force_filter(b, device=CPU)
        sensors, filt2 = hardware.ingest(state, filt)
        assert sensors.joint_pos.shape == (b, 12)
        assert filt2.buf.shape == filt.buf.shape == (b, 4, 5)


class TestGazebo:
    def test_ingest_never_feeds_position(self):
        one = lambda *s: torch.ones((B,) + s)
        raw = gazebo.GazeboRawState(
            joint_q=one(12), joint_dq=one(12), foot_wrench_z=one(4),
            odom_quat=torch.tensor([[1.0, 0, 0, 0]]).expand(B, 4),
            imu_acc=one(3), imu_gyro=one(3))
        s = gazebo.ingest(raw)
        assert torch.all(s.root_pos == 0) and torch.all(s.root_lin_vel == 0)
        assert torch.all(s.joint_pos == 1.0)

    def test_matches_jax(self):
        arrays = _rand(1, joint_q=(12,), joint_dq=(12,),
                       foot_wrench_z=(4,), odom_quat=(4,), imu_acc=(3,),
                       imu_gyro=(3,))
        raw, jraw = _both(gazebo.GazeboRawState, jgz.GazeboRawState, arrays)
        _exact(gazebo.ingest(raw), jax.vmap(jgz.ingest)(jraw))
        tau = arrays["joint_q"] * 10.0
        _exact(gazebo.egress(torch.tensor(tau)),
               jax.vmap(jgz.egress)(jnp.asarray(tau)))

    def test_egress_tau_only(self):
        tau = torch.arange(12.0)[None].expand(B, 12)
        cmds = gazebo.egress(tau)
        assert torch.all(cmds.mode == 0x0A)
        assert torch.all(cmds.kp == 0) and torch.all(cmds.kd == 0)
        assert torch.equal(cmds.tau, tau)


class TestIsaac:
    def test_ingest_consumes_gt_position(self):
        raw = isaac.IsaacRawState(
            joint_q=torch.zeros(B, 12), joint_dq=torch.zeros(B, 12),
            foot_force=torch.tensor([[1.0, 2, 3, 4]]).expand(B, 4),
            contact_flag=torch.tensor([[1.0, 0, 0, 1]]).expand(B, 4),
            gt_quat=torch.tensor([[1.0, 0, 0, 0]]).expand(B, 4),
            gt_pos=torch.tensor([[1.0, 2.0, 0.3]]).expand(B, 3),
            imu_acc=torch.zeros(B, 3), imu_gyro=torch.zeros(B, 3))
        s = isaac.ingest(raw, root_lin_vel=torch.tensor(
            [[0.1, 0.0, 0.0]]).expand(B, 3))
        np.testing.assert_allclose(s.root_pos[0].numpy(), [1.0, 2.0, 0.3])
        np.testing.assert_allclose(s.root_lin_vel[0].numpy(),
                                   [0.1, 0.0, 0.0])
        np.testing.assert_allclose(s.foot_force[0].numpy(), [1, 2, 3, 4])

    def test_matches_jax(self):
        arrays = _rand(2, joint_q=(12,), joint_dq=(12,), foot_force=(4,),
                       contact_flag=(4,), gt_quat=(4,), gt_pos=(3,),
                       imu_acc=(3,), imu_gyro=(3,))
        vel = _rand(3, v=(3,))["v"]
        raw, jraw = _both(isaac.IsaacRawState, jis.IsaacRawState, arrays)
        _exact(isaac.ingest(raw, torch.tensor(vel)),
               jax.vmap(jis.ingest)(jraw, jnp.asarray(vel)))
        _exact(isaac.egress(torch.tensor(vel)),
               jax.vmap(jis.egress)(jnp.asarray(vel)))

    def test_egress(self):
        cmd = isaac.egress(torch.arange(12.0)[None].expand(B, 12))
        np.testing.assert_allclose(cmd.effort[0].numpy(), np.arange(12.0))
