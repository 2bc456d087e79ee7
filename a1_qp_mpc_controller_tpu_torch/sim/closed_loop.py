"""Closed-loop rollout: controller and plant in a loop (counterpart of
``sim/closed_loop.py``: ``LoopCarry``, ``Trace``, ``make_standing_start``,
``rollout`` and ``joy_schedule``), over a batch of scenarios."""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.config import A1Config, RobotParams
from a1_qp_mpc_controller_tpu_torch.control.controller import control_tick
from a1_qp_mpc_controller_tpu_torch.sim import plant as plant_mod
from a1_qp_mpc_controller_tpu_torch.sim import terrain as terrain_mod
from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, check_on, const, resolve_device, tensorclass, tree_map,
)
from a1_qp_mpc_controller_tpu_torch.types import CtrlMem, CtrlState, JoyCmd


@tensorclass
class LoopCarry:
    cs: CtrlState
    mem: CtrlMem
    ps: plant_mod.PlantState      # or joint_plant.JointPlantState
    prev_root_lin_vel: torch.Tensor


@tensorclass
class Trace:
    """Per-tick telemetry of a rollout, (T, B, ...) on every field."""

    root_pos: torch.Tensor          # (T,B,3) true body position
    root_euler_est: torch.Tensor    # (T,B,3) the controller's view
    est_root_pos: torch.Tensor      # (T,B,3) estimator output
    foot_forces_grf: torch.Tensor   # (T,B,4,3) commanded GRFs (body frame)
    joint_torques: torch.Tensor     # (T,B,12)
    contacts: torch.Tensor          # (T,B,4)
    foot_force_sensor: torch.Tensor  # (T,B,4)
    root_lin_vel: torch.Tensor      # (T,B,3) true body velocity
    # per-foot swing tracking, yaw-aligned body frame
    swing_target: torch.Tensor      # (T,B,4,3) Bezier target this tick
    swing_actual: torch.Tensor      # (T,B,4,3) actual foot position
    swing_err: torch.Tensor         # (T,B,4) |target - actual|


def make_standing_start(cfg: A1Config, params: RobotParams,
                        terrain: terrain_mod.Terrain, height: float = 0.3,
                        plant=plant_mod, device=CUDA) -> LoopCarry:
    """Standing start for a batch; the controller's root state is seeded
    with the true pose so the first ticks (before the EKF converges) are
    sane. ``plant`` selects the physics backend: ``sim.plant`` (SRB and
    massless legs, the default) or ``sim.joint_plant`` (18-DoF
    articulated)."""
    ps = plant.init_standing(params, terrain, height, device=device)
    cs = CtrlState.init(cfg, params, device=device)
    cs = cs.replace(root_pos=ps.root_pos,
                    joy_body_height=torch.full_like(cs.joy_body_height,
                                                    height))
    mem = CtrlMem.init(cfg, params, device=device)
    return LoopCarry(cs=cs, mem=mem, ps=ps,
                     prev_root_lin_vel=ps.root_lin_vel)


def rollout(cfg: A1Config, params: RobotParams,
            terrain: terrain_mod.Terrain, carry: LoopCarry,
            joy_seq: JoyCmd, n_steps: int, substeps: int = 5,
            plant=plant_mod, device=CUDA) -> tuple[LoopCarry, Trace]:
    """Run ``n_steps`` control periods of ``read_sensors`` ->
    ``control_tick`` -> ``plant_step`` over the batch; ``joy_seq`` has a
    leading (T,) axis on every field (:func:`joy_schedule`). ``plant`` is
    the physics backend module (``sim.plant`` or ``sim.joint_plant``),
    which must match the carry's plant state. Returns the last carry and
    the Trace stacked on a leading T axis, the batch axis after it."""
    device = check_on(device, carry.ps.root_pos)
    dt = const(cfg.control_dt, carry.ps.root_pos.dtype, device)
    traces = []
    for t in range(n_steps):
        sensors = plant.read_sensors(params, carry.ps,
                                     carry.prev_root_lin_vel, dt)
        cs, mem, torques = control_tick(
            cfg, params, carry.cs, carry.mem, sensors,
            tree_map(lambda a: a[t], joy_seq), dt)
        ps = plant.plant_step(params, terrain, carry.ps, torques, dt,
                              substeps)
        carry = LoopCarry(cs=cs, mem=mem, ps=ps,
                          prev_root_lin_vel=carry.ps.root_lin_vel)
        traces.append(Trace(
            root_pos=ps.root_pos, root_euler_est=cs.root_euler,
            est_root_pos=cs.estimated_root_pos,
            foot_forces_grf=cs.foot_forces_grf, joint_torques=torques,
            contacts=cs.contacts, foot_force_sensor=ps.foot_force_n,
            root_lin_vel=ps.root_lin_vel,
            swing_target=cs.foot_pos_target_last_time,
            swing_actual=cs.foot_pos_cur,
            swing_err=torch.linalg.vector_norm(
                cs.foot_pos_target_last_time - cs.foot_pos_cur, dim=-1)))
    return carry, tree_map(lambda *xs: torch.stack(xs), *traces)


def joy_schedule(n_steps: int, *, walk_after: int | None = None,
                 velx: float = 0.0, vely: float = 0.0,
                 yaw_rate: float = 0.0, device=CUDA) -> JoyCmd:
    """A (T,)-leading JoyCmd sequence: stand until ``walk_after``, then
    walk with the given velocity command."""
    device = resolve_device(device)
    t = torch.arange(n_steps, device=device)
    walking = (torch.zeros(n_steps, dtype=torch.bool, device=device)
               if walk_after is None else t >= walk_after)
    z = torch.zeros(n_steps, device=device)
    w = walking.float()
    return JoyCmd(velx=w * velx, vely=w * vely, velz=z,
                  roll_rate=z, pitch_rate=z, yaw_rate=w * yaw_rate,
                  ctrl_state=walking.to(torch.int32),
                  exit=torch.zeros(n_steps, dtype=torch.bool, device=device))
