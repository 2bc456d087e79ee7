"""Single-scenario real-time harness and the hardware's dual-rate schedule
(counterpart of ``runtime/realtime.py``): ``pack_sensors`` /
``unpack_sensors``, the 44-float sensor frame; ``run_dual_rate_sim``,
estimation at the 500 Hz sensor rate and control at 400 Hz on a merged
timeline, over a batch of scenarios, without threads; and
``RealtimeRunner``, the functional equivalent of the reference's
Main{Gazebo,Hardware,Isaac} executables (SURVEY.md §1 L5), whose thread
topology mirrors the reference:

- a *sensor producer* (here the port's plant, or any external feed)
  pushes frames into the native SPSC ring at its own rate (the
  reference's 500 Hz UDP receive thread, HardwareA1ROS.cpp:89);
- the native periodic executor (``runtime/native.py``) runs the control
  tick at 400 Hz with solve-time compensation (MainHardware.cpp:85-130),
  consuming the freshest sensor frame each period;
- per-tick latency, jitter and deadline-miss statistics come from the
  native loop.

The runner's tick is eager PyTorch on one scenario (a batch of one) on
the card; the "shared blackboard" is the (CtrlState, CtrlMem) pair handed
from tick to tick. Both threads enqueue on the device's current stream.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from a1_qp_mpc_controller_tpu_torch.config import (
    A1Config, RobotParams, load_profile,
)
from a1_qp_mpc_controller_tpu_torch.control.controller import (
    control_tick, control_tick_noest, estimate_step, merge_estimate_cs,
    merge_estimate_mem,
)
from a1_qp_mpc_controller_tpu_torch.runtime.native import RtLoop, SensorRing
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as cl
from a1_qp_mpc_controller_tpu_torch.sim import plant as plant_mod
from a1_qp_mpc_controller_tpu_torch.sim import terrain as terrain_mod
from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, broadcast_batch, check_on, const, resolve_device,
)
from a1_qp_mpc_controller_tpu_torch.types import JoyCmd, SensorData

# quaternion, position, velocity, IMU acceleration and rate, joint
# positions and velocities, foot forces
_FRAME = (("root_quat", 4), ("root_pos", 3), ("root_lin_vel", 3),
          ("imu_acc", 3), ("imu_ang_vel", 3), ("joint_pos", 12),
          ("joint_vel", 12), ("foot_force", 4))
SENSOR_FRAME_LEN = sum(n for _, n in _FRAME)  # 44 floats


def pack_sensors(s: SensorData) -> np.ndarray:
    """(B, 44) float32 frames of a batch of sensor snapshots (one copy to
    the host)."""
    return torch.cat([getattr(s, name).detach().to(torch.float32)
                      for name, _ in _FRAME], dim=-1).cpu().numpy()


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


# the telemetry record's fields and their decimals (None: 0/1 flags), the
# JAX runner's keys and roundings
_TELEMETRY = (("root_pos", 4), ("root_pos_d", 4), ("root_euler", 4),
              ("root_euler_d", 4), ("root_lin_vel", 4), ("contacts", None),
              ("foot_forces_grf", 2), ("joint_torques", 3),
              ("terrain_pitch_angle", 4))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stop_all(loops) -> None:
    """Join every loop, then raise the first exception a loop's callback
    raised (in the order of ``loops``)."""
    errors = []
    for loop in loops:
        try:
            loop.stop()
        except BaseException as e:  # re-raised below, once all are joined
            errors.append(e)
    if errors:
        raise errors[0]


class RealtimeRunner:
    """Runs the controller at a fixed wall-clock rate against a sensor ring,
    with an in-process plant producer (swap the producer for a robot I/O
    shim on real hardware), one scenario on ``device``.

    ``estimation_rate_hz``: when set (hardware parity: 500.0), the EKF
    runs inside the sensor-rate loop on every frame (the reference runs
    estimation in its 500 Hz UDP receive thread,
    HardwareA1ROS.cpp:336-341) and the 400 Hz control tick consumes the
    latest estimate without re-ingesting. When None (sim parity),
    estimation runs inside the control tick as Gazebo/Isaac do.

    Every function the loops call runs once at the start of :meth:`run`,
    before the loops, so the first launches on the card happen before any
    deadline. A callback that raises fails :meth:`run`, with both loops
    stopped."""

    def __init__(self, profile: str = "gazebo_mpc",
                 mpc_iters: int = 50, solver_mode: str = "fixed",
                 terrain: Optional[terrain_mod.Terrain] = None,
                 estimation_rate_hz: Optional[float] = None,
                 telemetry_jsonl: Optional[str] = None,
                 telemetry_every: int = 10, device=CUDA):
        self.device = resolve_device(device)
        cfg, params = load_profile(profile, device=self.device)
        self.cfg: A1Config = dataclasses.replace(
            cfg, mpc_qp_iters=mpc_iters, mpc_solver_mode=solver_mode)
        self.params: RobotParams = broadcast_batch(params, 1)
        self.terrain = terrain or terrain_mod.Terrain.flat(
            1, device=self.device)
        dtype = self.params.robot_mass.dtype
        self.dt = const(self.cfg.control_dt, dtype, self.device)

        carry = cl.make_standing_start(self.cfg, self.params, self.terrain,
                                       device=self.device)
        self.cs, self.mem, self.ps = carry.cs, carry.mem, carry.ps
        self.prev_vel = carry.prev_root_lin_vel
        self.joy = JoyCmd.zeros(device=self.device)
        self.ring = SensorRing(SENSOR_FRAME_LEN)

        self.est_rate = estimation_rate_hz
        self.sensor_dt = (1.0 / estimation_rate_hz
                          if estimation_rate_hz else 0.002)
        self.s_dt = const(self.sensor_dt, dtype, self.device)
        self.torques = torch.zeros_like(self.cs.joint_torques)
        self._latencies_ms: list = []
        # live debug stream: one JSON line per N control ticks with the
        # quantities the reference publishes as rviz/debug topics during
        # a run (estimated pose, desired pose, contacts, GRFs, torques,
        # A1RobotControl.cpp:60-146); `tail -f` is the rviz stand-in.
        # Append mode: a long-lived embedder may run() repeatedly against
        # one file
        self._telemetry_every = max(1, telemetry_every)
        self._telemetry_fp = (open(telemetry_jsonl, "a")
                              if telemetry_jsonl else None)
        self.ticks = 0   # control ticks run, over every run()

    def _warm(self) -> None:
        """Run each function the loops call once on the current state and
        joystick, results discarded: the value-dependent paths (standing
        or walking) and their first launches happen before any
        deadline."""
        s0 = plant_mod.read_sensors(self.params, self.ps, self.prev_vel,
                                    self.dt)
        s0 = unpack_sensors(pack_sensors(s0)[0], device=self.device)
        _, _, tq = control_tick(self.cfg, self.params, self.cs, self.mem,
                                s0, self.joy, self.dt)
        plant_mod.plant_step(self.params, self.terrain, self.ps, tq,
                             self.dt)
        if self.est_rate:
            cs, mem = estimate_step(self.cfg, self.params, self.cs,
                                    self.mem, s0, self.s_dt)
            cs = merge_estimate_cs(cs, self.cs)
            mem = merge_estimate_mem(mem, self.mem)
            control_tick_noest(self.cfg, self.params, cs, mem, self.joy,
                               self.dt)
        _sync(self.device)

    def _emit_telemetry(self) -> None:
        if self._telemetry_fp is None or self.ticks % self._telemetry_every:
            return
        cs = self.cs
        # the scenario's fields in one copy to the host (bools as 0.0/1.0)
        fields = [getattr(cs, name)[0] for name, _ in _TELEMETRY]
        flat = torch.cat([f.reshape(-1).to(torch.float32)
                          for f in fields]).cpu().numpy()
        host, at = {}, 0
        for (name, _), f in zip(_TELEMETRY, fields):
            host[name] = flat[at:at + f.numel()].reshape(tuple(f.shape))
            at += f.numel()
        rec = {"tick": self.ticks,
               "t_s": round(self.ticks * float(self.cfg.control_dt), 4)}
        for name, digits in _TELEMETRY[:-1]:
            rec[name] = (host[name].astype(int).tolist() if digits is None
                         else host[name].round(digits).tolist())
        rec["terrain_pitch"] = round(float(host["terrain_pitch_angle"]), 4)
        self._telemetry_fp.write(json.dumps(rec) + "\n")
        self._telemetry_fp.flush()

    # sensor producer: read the plant's sensors and push them
    def _produce(self, _tick_idx: int) -> None:
        s = plant_mod.read_sensors(self.params, self.ps, self.prev_vel,
                                   self.dt)
        self.ring.push(pack_sensors(s)[0])

    def _produce_estimate(self, _tick_idx: int) -> None:
        """Sensor-rate thread in hardware-parity mode: advance the plant at
        the SENSOR rate with the latest torques, push the frame, and run
        ingest and the EKF on it (the reference's receive thread ingests
        and estimates, HardwareA1ROS.cpp:245-378; the robot's physics runs
        continuously). Advancing the plant here, not in the control loop,
        keeps the finite-difference IMU acceleration consistent with the
        sensor period, as in ``run_dual_rate_sim``."""
        s = plant_mod.read_sensors(self.params, self.ps, self.prev_vel,
                                   self.s_dt)
        self.prev_vel = self.ps.root_lin_vel
        self.ps = plant_mod.plant_step(self.params, self.terrain, self.ps,
                                       self.torques, self.s_dt)
        self.ring.push(pack_sensors(s)[0])
        frame = self.ring.pop_latest()
        if frame is None:
            return
        cs, mem = estimate_step(self.cfg, self.params, self.cs, self.mem,
                                unpack_sensors(frame, device=self.device),
                                self.s_dt)
        # publish only the estimation's fields, merged into the control
        # thread's CURRENT (cs, mem), so that a planning or warm-start
        # write made meanwhile is not lost (the reference's receive thread
        # writes only the estimation's blackboard fields)
        self.mem = merge_estimate_mem(mem, self.mem)
        self.cs = merge_estimate_cs(cs, self.cs)

    def _consume(self, _tick_idx: int) -> None:
        frame = self.ring.pop_latest()
        if frame is None:
            return
        sensors = unpack_sensors(frame, device=self.device)
        t0 = time.perf_counter()
        cs, mem, torques = control_tick(self.cfg, self.params, self.cs,
                                        self.mem, sensors, self.joy,
                                        self.dt)
        _sync(self.device)
        self._latencies_ms.append((time.perf_counter() - t0) * 1e3)
        self.cs, self.mem = cs, mem
        self.prev_vel = self.ps.root_lin_vel
        self.ps = plant_mod.plant_step(self.params, self.terrain, self.ps,
                                       torques, self.dt)
        self.ticks += 1
        self._emit_telemetry()

    def _consume_noest(self, _tick_idx: int) -> None:
        """Control-rate thread in hardware-parity mode: consume the
        latest estimate, no re-ingest. The plant advances in the sensor
        loop (``_produce_estimate``); this thread only publishes the new
        torque command, like the reference's send_cmd."""
        t0 = time.perf_counter()
        cs, mem, torques = control_tick_noest(self.cfg, self.params,
                                              self.cs, self.mem, self.joy,
                                              self.dt)
        _sync(self.device)
        self._latencies_ms.append((time.perf_counter() - t0) * 1e3)
        self.cs, self.mem, self.torques = cs, mem, torques
        self.ticks += 1
        self._emit_telemetry()

    def run(self, seconds: float, joy: Optional[JoyCmd] = None) -> dict:
        """Run both loops for ``seconds`` of wall clock (less if a
        callback raises: then both loops stop and its exception is
        raised). Returns the control loop's statistics, the tick
        latencies' p50 and p99, the ring's dropped frames, the control
        ticks run so far (``ticks``), the warm-up's seconds (``warm_s``)
        and the plant's final position."""
        if joy is not None:
            self.joy = joy
        t0 = time.perf_counter()
        self._warm()
        warm_s = time.perf_counter() - t0
        if self.est_rate:
            sensor_loop = RtLoop(self.sensor_dt, self._produce_estimate,
                                 compensate=False)
            ctrl_loop = RtLoop(float(self.cfg.control_dt),
                               self._consume_noest, compensate=True)
        else:
            sensor_loop = RtLoop(self.sensor_dt, self._produce,
                                 compensate=False)
            ctrl_loop = RtLoop(float(self.cfg.control_dt), self._consume,
                               compensate=True)
        loops = (ctrl_loop, sensor_loop)
        try:
            sensor_loop.start()
            ctrl_loop.start()
            end = time.perf_counter() + seconds
            while (time.perf_counter() < end
                   and not any(loop.error for loop in loops)):
                time.sleep(0.01)
        finally:
            _stop_all(loops)
        stats = ctrl_loop.stats()
        lat = sorted(self._latencies_ms)
        if lat:
            stats["solve_p50_ms"] = lat[len(lat) // 2]
            stats["solve_p99_ms"] = lat[int(len(lat) * 0.99)]
        stats["ring_dropped"] = self.ring.dropped
        stats["ticks"] = self.ticks
        stats["warm_s"] = warm_s
        stats["root_pos"] = self.ps.root_pos[0].tolist()
        if self._telemetry_fp is not None:
            self._telemetry_fp.flush()
        return stats

    def close(self) -> None:
        """Release the telemetry file handle (idempotent). Call when
        embedding RealtimeRunner long-lived; __exit__ calls it too."""
        if self._telemetry_fp is not None:
            self._telemetry_fp.close()
            self._telemetry_fp = None

    def __enter__(self) -> "RealtimeRunner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
