"""Stance-force computation, MPC path (counterpart of the MPC subset of
``control/grf.py``): terrain adaptation, the per-contact-pattern scaling
lookup, the condensed MPC QP with its warm-start/flip/rescue-window
bookkeeping, applying a solution, and ``compute_grf``'s MPC branch over a
batch. The stand-QP branch is not ported yet."""

from __future__ import annotations

from typing import Tuple

import torch

from a1_qp_mpc_controller_tpu_torch.config import (
    A1Config, GRAVITY, NUM_LEG, RobotParams,
)
from a1_qp_mpc_controller_tpu_torch.models import srb
from a1_qp_mpc_controller_tpu_torch.ops import qp as qpx
from a1_qp_mpc_controller_tpu_torch.tensors import (
    const, select_tree, tensorclass, where_b,
)
from a1_qp_mpc_controller_tpu_torch.types import CtrlMem, CtrlState
from a1_qp_mpc_controller_tpu_torch.utils import mathx
from a1_qp_mpc_controller_tpu_torch.utils.filters import filter_update_masked

# initial ADMM stepsize of the (Ruiz-scaled, swing-eliminated) MPC family
_MPC_RHO0 = 3e-3
# post-flip rescue window (ticks)
FLIP_COOLDOWN_TICKS = 4


def scaling_for_contacts(table: qpx.Scaling, contacts: torch.Tensor
                         ) -> qpx.Scaling:
    """Pick each scenario's entry of its 16-pattern table (B,16,...) by
    its contact pattern id contacts . [8, 4, 2, 1]."""
    weights = const((8, 4, 2, 1), torch.int64, contacts.device)
    idx = torch.sum(contacts.to(torch.int64) * weights, dim=1)
    rows = torch.arange(contacts.shape[0], device=contacts.device)
    return qpx.Scaling(d=table.d[rows, idx], e=table.e[rows, idx],
                       c=table.c[rows, idx])


def compute_walking_surface(cs: CtrlState) -> torch.Tensor:
    """LS plane fit z = a0 + a1 x + a2 y over the recent contact points;
    returns (B, 3) normal coefficients [a1, a2, -1]."""
    rc = cs.foot_pos_recent_contact
    w = torch.cat([torch.ones_like(rc[:, :, :1]), rc[:, :, :2]], dim=2)
    z = rc[:, :, 2]
    wt = w.transpose(1, 2)
    a = torch.einsum("bij,bj->bi", mathx.pseudo_inverse_3x3(wt @ w),
                     torch.einsum("bij,bj->bi", wt, z))
    return torch.stack([a[:, 1], a[:, 2], -torch.ones_like(a[:, 0])], dim=1)


def terrain_adaptation(cfg: A1Config, cs: CtrlState, mem: CtrlMem
                       ) -> Tuple[CtrlState, CtrlMem]:
    """Estimate the terrain pitch and (optionally) overwrite the desired
    pitch (A1RobotControl.cpp:334-375)."""
    surf_coef = compute_walking_surface(cs)
    flat = const((0.0, 0.0, 1.0), surf_coef.dtype, surf_coef.device)
    raw_angle = mathx.cal_dihedral_angle(flat, surf_coef)
    body_high = cs.root_pos[:, 2] > 0.1
    t_filter, avg = filter_update_masked(mem.terrain_angle_filter,
                                         raw_angle, body_high)
    terrain_angle = torch.clamp(torch.where(body_high, avg, 0.0), -0.5, 0.5)
    z = cs.foot_pos_recent_contact[:, :, 2]
    f_r_diff = z[:, 0] + z[:, 1] - z[:, 2] - z[:, 3]
    pitch_d = torch.where(f_r_diff > 0.05, -terrain_angle, terrain_angle)
    root_euler_d = cs.root_euler_d
    if cfg.use_terrain_adapt:
        root_euler_d = torch.stack([root_euler_d[:, 0], pitch_d,
                                    root_euler_d[:, 2]], dim=1)
    cs = cs.replace(root_euler_d=root_euler_d,
                    terrain_pitch_angle=terrain_angle)
    return cs, mem.replace(terrain_angle_filter=t_filter)


@tensorclass
class MpcProblem:
    """One tick's condensed MPC QP + warm-start data, batched.
    ``a_mat`` is None when built with ``with_a_mat=False``: the
    shared-basis solve never materializes the per-scenario constraint
    matrix A = A0 + mu A1; only the legacy route reads it."""

    p_mat: torch.Tensor          # (B,120,120)
    q_vec: torch.Tensor          # (B,120)
    a_mat: torch.Tensor | None   # (B,200,120) or None
    lb: torch.Tensor             # (B,200)
    ub: torch.Tensor             # (B,200)
    warm_x: torch.Tensor         # (B,120)
    warm_y: torch.Tensor         # (B,200)
    rho0: torch.Tensor           # (B,)
    flipped: torch.Tensor        # (B,) bool: a contact flip this tick
    rescue_flag: torch.Tensor    # (B,) bool: flip or post-flip window


def mpc_problem(cfg: A1Config, params: RobotParams, cs: CtrlState,
                mem: CtrlMem, dt: torch.Tensor,
                with_a_mat: bool = False) -> MpcProblem:
    """Build the tick's MPC QP (A1RobotControl.cpp:446-518) with swing
    elimination, the flip-masked and load-rescaled warm start, the
    cross-tick rho carry and the rescue-window flags. Pure."""
    dtype, dev = cs.root_pos.dtype, cs.root_pos.device
    b = cs.root_pos.shape[0]
    h = cfg.horizon
    mpc_states = torch.cat([
        cs.root_euler, cs.root_pos, cs.root_ang_vel, cs.root_lin_vel,
        torch.full((b, 1), -GRAVITY, dtype=dtype, device=dev)], dim=1)
    mpc_dt = dt if cfg.use_sim_time else const(0.0025, dtype, dev)
    lin_vel_d_world = torch.einsum("bij,bj->bi", cs.root_rot_mat,
                                   cs.root_lin_vel_d)
    x_ref = srb.build_reference_trajectory(
        cs.root_euler, cs.root_pos, cs.root_pos_d, cs.root_euler_d,
        cs.root_ang_vel_d, lin_vel_d_world, mpc_dt, h)

    a_c = srb.continuous_a(cs.root_euler)
    if cfg.mpc_receding_footholds:
        steps = torch.arange(h, dtype=dtype, device=dev) * mpc_dt
        feet_h = (cs.foot_pos_abs[:, None, :, :]
                  - steps[None, :, None, None]
                  * lin_vel_d_world[:, None, None, :])          # (B,H,4,3)
        b_c_list = srb.continuous_b(
            params.robot_mass[:, None], params.trunk_inertia[:, None],
            cs.root_rot_mat[:, None], feet_h)
        a_qp, b_qp = srb.condense(a_c, b_c_list * mpc_dt, mpc_dt, h)
    else:
        b_c = srb.continuous_b(params.robot_mass, params.trunk_inertia,
                               cs.root_rot_mat, cs.foot_pos_abs)
        _, b_d = srb.discretize(a_c, b_c, mpc_dt)
        a_qp, b_qp = srb.condense_same_b(a_c, b_d, mpc_dt, h)
    p_mat, q_vec = srb.mpc_cost(a_qp, b_qp, params.q_weights,
                                params.r_weights, mpc_states, x_ref, h,
                                contacts=cs.contacts)
    a_mat = (srb.friction_constraint_matrix(params.mu_mpc, h)
             if with_a_mat else None)
    lb, ub = srb.mpc_bounds(cs.contacts, params.fz_min, params.fz_max, h)
    s_var = srb.tile_last(cs.contacts.repeat_interleave(3, dim=1), h)
    s_row = srb.tile_last(cs.contacts.repeat_interleave(5, dim=1), h)
    lb = torch.where(s_row, lb, -float("inf"))
    ub = torch.where(s_row, ub, float("inf"))

    started = mem.mpc_warm_started
    warm_x = where_b(started, mem.mpc_warm_x, torch.zeros_like(mem.mpc_warm_x))
    warm_y = where_b(started, mem.mpc_warm_y, torch.zeros_like(mem.mpc_warm_y))
    if cfg.mpc_warm_extrapolate > 0.0:
        g = const(cfg.mpc_warm_extrapolate, dtype, dev)
        warm_x = warm_x + g * mem.mpc_warm_dx
        warm_y = warm_y + g * mem.mpc_warm_dy
    rho_init = torch.full((b,), _MPC_RHO0, dtype=dtype, device=dev)
    rho0 = torch.where(started, mem.mpc_rho, rho_init)
    leg_flip = cs.contacts != mem.mpc_prev_contacts              # (B,4)
    any_flip = torch.any(leg_flip, dim=1)
    var_keep = srb.tile_last((~leg_flip).repeat_interleave(3, dim=1), h)
    row_keep = srb.tile_last((~leg_flip).repeat_interleave(5, dim=1), h)
    wx = warm_x.reshape(b, h, NUM_LEG, 3)
    fz_before = torch.sum(wx[:, :, :, 2] * mem.mpc_prev_contacts[:, None, :],
                          dim=2)                                  # (B,H)
    warm_x = torch.where(var_keep & s_var, warm_x, 0.0)
    warm_y = torch.where(row_keep & s_row, warm_y, 0.0)
    wx2 = warm_x.reshape(b, h, NUM_LEG, 3)
    fz_after = torch.sum(wx2[:, :, :, 2], dim=2)
    scale = torch.clamp(fz_before / torch.clamp(fz_after, min=1.0), 1.0, 4.0)
    scale = where_b(any_flip, scale, torch.ones_like(scale))
    warm_x = (wx2 * scale[:, :, None, None]).reshape(b, -1)
    rho0 = torch.where(any_flip, rho_init, rho0)
    flipped = any_flip & started

    cd = mem.mpc_flip_cooldown
    dense = cd > max(0, cfg.mpc_cooldown_ticks - cfg.mpc_cooldown_dense)
    if cfg.mpc_cooldown_stride > 1:
        strided = (cd > 0) & ((mem.tick % cfg.mpc_cooldown_stride) == 0)
    else:
        strided = cd > 0
    rescue_flag = flipped | dense | strided
    if cfg.mpc_drift_rescue_n > 0.0:
        slew = torch.amax(torch.abs(mem.mpc_warm_dx[:, :12]), dim=1)
        rescue_flag = rescue_flag | ((slew > cfg.mpc_drift_rescue_n)
                                     & started)
    if cfg.mpc_solver_mode != "fixed":
        warm_x = where_b(flipped, torch.zeros_like(warm_x), warm_x)
        warm_y = where_b(flipped, torch.zeros_like(warm_y), warm_y)
    return MpcProblem(p_mat=p_mat, q_vec=q_vec, a_mat=a_mat, lb=lb, ub=ub,
                      warm_x=warm_x, warm_y=warm_y, rho0=rho0,
                      flipped=flipped, rescue_flag=rescue_flag)


def mpc_apply_solution(cfg: A1Config, cs: CtrlState, mem: CtrlMem,
                       sol: qpx.QPSolution) -> Tuple[CtrlState, CtrlMem]:
    """Store warm-start state (clamped rho carry, cooldown window,
    inter-tick delta) and map the world-frame forces into the body frame
    with the per-leg NaN guard."""
    b = cs.root_pos.shape[0]
    rho_carry = torch.clamp(sol.rho, 0.1 * _MPC_RHO0, 100.0 * _MPC_RHO0)
    started = mem.mpc_warm_started
    flipped_now = (torch.any(cs.contacts != mem.mpc_prev_contacts, dim=1)
                   & started)
    cooldown = torch.where(
        flipped_now,
        torch.full_like(mem.mpc_flip_cooldown,
                        max(cfg.mpc_cooldown_ticks, FLIP_COOLDOWN_TICKS)),
        torch.clamp(mem.mpc_flip_cooldown - 1, min=0))
    ok_delta = started & ~flipped_now
    mem = mem.replace(
        mpc_warm_x=sol.x, mpc_warm_y=sol.y,
        mpc_warm_dx=where_b(ok_delta, sol.x - mem.mpc_warm_x,
                            torch.zeros_like(sol.x)),
        mpc_warm_dy=where_b(ok_delta, sol.y - mem.mpc_warm_y,
                            torch.zeros_like(sol.y)),
        mpc_rho=rho_carry,
        mpc_warm_started=torch.ones_like(started),
        mpc_prev_contacts=cs.contacts,
        mpc_flip_cooldown=cooldown)
    forces_world = sol.x[:, :12].reshape(b, NUM_LEG, 3)
    forces_body = torch.einsum("bji,blj->bli", cs.root_rot_mat, forces_world)
    bad = torch.isnan(torch.sum(forces_body, dim=2))
    forces_body = torch.where(bad[:, :, None], cs.foot_forces_grf,
                              forces_body)
    return cs.replace(foot_forces_grf=forces_body), mem


def compute_grf(cfg: A1Config, params: RobotParams, cs: CtrlState,
                mem: CtrlMem, dt: torch.Tensor
                ) -> Tuple[CtrlState, CtrlMem]:
    """The per-tick stance-force solve over a batch, each scenario as the
    JAX package's ``compute_grf`` under ``vmap``; returns body-frame GRFs
    in ``cs.foot_forces_grf`` and the updated solver memory.

    MPC profiles: terrain adaptation, the condensed QP, then
    - fixed mode: ``mpc_qp_iters`` iterations; the flip rescue
      (``mpc_rescue_iters``: a refactor at the clamped rho estimate where
      the first pass failed) and the round-robin polish
      (``mpc_polish_iters`` every ``mpc_polish_every`` ticks). Each is a
      ``lax.cond`` on a per-scenario predicate in the JAX package, which
      ``vmap`` turns into both branches and a select: so here too, with
      no host read;
    - adaptive mode: ``admm_solve`` to 1e-5 within ``mpc_qp_iters``, then
      75 fixed iterations past the exit.
    The stand-QP branch (``stance_leg_control_type == 0``) raises."""
    if cfg.stance_leg_control_type == 0:
        raise NotImplementedError(
            "compute_grf's stand-QP branch is not ported: ROADMAP.md, "
            "'The other batched routes'")
    cs, mem = terrain_adaptation(cfg, cs, mem)
    prob = mpc_problem(cfg, params, cs, mem, dt, with_a_mat=True)
    scal = qpx.rescale_cost(prob.p_mat, prob.q_vec, scaling_for_contacts(
        mem.mpc_scaling_table, cs.contacts))
    settings = qpx.QPSettings(rho=_MPC_RHO0)

    def fixed(iters, x0, y0, rho0):
        return qpx.admm_solve_fixed(
            prob.p_mat, prob.q_vec, prob.a_mat, prob.lb, prob.ub, iters,
            settings, x0=x0, y0=y0, rho0=rho0, scaling=scal)

    if cfg.mpc_solver_mode == "fixed":
        sol = fixed(cfg.mpc_qp_iters, prob.warm_x, prob.warm_y, prob.rho0)
        if cfg.mpc_rescue_iters > 0:
            rho_r = torch.where(sol.converged, prob.rho0, torch.clamp(
                sol.rho, 0.1 * _MPC_RHO0, 100.0 * _MPC_RHO0))
            rescued = fixed(cfg.mpc_rescue_iters, sol.x, sol.y, rho_r)
            sol = select_tree(sol.converged & ~prob.rescue_flag, sol,
                              rescued)
        if cfg.mpc_polish_iters > 0 and cfg.mpc_polish_every > 0:
            due = (((mem.tick % cfg.mpc_polish_every) == 0) & sol.converged
                   & ~prob.rescue_flag)
            polished = fixed(cfg.mpc_polish_iters, sol.x, sol.y, prob.rho0)
            sol = select_tree(due, polished, sol)
    else:
        sol = qpx.admm_solve(
            prob.p_mat, prob.q_vec, prob.a_mat, prob.lb, prob.ub,
            qpx.QPSettings(rho=_MPC_RHO0, eps_abs=1e-5, eps_rel=1e-5,
                           max_iter=cfg.mpc_qp_iters,
                           check_every=cfg.qp_check_every),
            x0=prob.warm_x, y0=prob.warm_y, rho0=prob.rho0, scaling=scal)
        sol = fixed(75, sol.x, sol.y, prob.rho0)
    return mpc_apply_solution(cfg, cs, mem, sol)
