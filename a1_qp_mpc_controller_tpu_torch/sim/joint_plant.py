"""Joint-space articulated plant (counterpart of ``sim/joint_plant.py``):
floating-base rigid-body dynamics of the full 18-DoF quadruped (trunk and
4 x 3 revolute joints) with pinned-foot KKT contact, batched over a
leading scenario axis B.

The higher-fidelity alternative to the single-rigid-body plant of
``sim/plant.py``: joint torques act on the link inertias, so the Isaac
profiles' stiff swing gains (kp_foot 3250-4250, tuned against real leg
inertia) are exercised faithfully.

- Generalized velocity ``u = [v_b (world), w_b (world), qd (12)]``.
- Per-link body-frame COM positions, rotations and joint axes are closed
  forms in the leg angles. The JAX module takes their joint derivatives
  with ``jax.jacfwd`` and the velocity-product ("bias") accelerations
  with ``jax.jvp`` along the flow; here both are closed forms over the
  B x 4 legs (the screw axes of the chain), a few dozen batched ops in
  place of ``torch.func``'s several hundred.
- Mass matrix ``M = sum_i Jv_i' m_i Jv_i + Jw_i' I_i^w Jw_i`` over the 12
  leg links and the trunk; bias ``b`` by d'Alembert with the same
  Jacobians.
- Contact: feet pin to the terrain on touchdown. Pinned feet add rows
  ``J_c u_dot = -a_c^0 - stabilization`` to a symmetric 30 x 30 KKT
  system; free feet get zeroed rows and 1 on the dual diagonal (static
  shapes). One solve serves the acceleration and the inelastic
  touchdown impulse projection (two right-hand sides): a batched
  ``torch.linalg.solve_ex`` (the JAX package's XLA solve; no hand
  kernel), its ``info`` read once a ``plant_step``, raising on a
  singular system.
- Release when the constraint normal force lambda_z < 0.

The link constants approximate the public Unitree A1 URDF. As in the JAX
module, whose module-level arrays are float32 whatever the run's
precision, the arrays below are float32 numbers, cast to the state's
dtype; the trunk takes ``robot_mass - 4 * LEG_MASS`` and
``trunk_inertia`` from ``RobotParams``.
"""

from __future__ import annotations

import numpy as np
import torch

from a1_qp_mpc_controller_tpu_torch.config import NUM_LEG, RobotParams
from a1_qp_mpc_controller_tpu_torch.models import kinematics as kin
from a1_qp_mpc_controller_tpu_torch.sim import plant as plant_mod
from a1_qp_mpc_controller_tpu_torch.sim import terrain as terrain_mod
from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, const, host_bool, tensorclass,
)
from a1_qp_mpc_controller_tpu_torch.types import SensorData
from a1_qp_mpc_controller_tpu_torch.utils import mathx


def _f32(values) -> tuple:
    """``values`` rounded to float32, as Python floats (the JAX module's
    float32 constant arrays)."""
    return tuple(np.asarray(values, np.float32).astype(np.float64).tolist())


GRAV = _f32((0.0, 0.0, -9.81))

# --- link constants (approximate A1 URDF; COM lateral offsets mirror with
# the motor-offset sign of each leg)
HIP_MASS = 0.696
THIGH_MASS = 1.013
CALF_MASS = 0.286            # calf 0.226 + foot 0.06 lumped
LEG_MASS = HIP_MASS + THIGH_MASS + CALF_MASS
LINK_MASSES = _f32((HIP_MASS, THIGH_MASS, CALF_MASS))
# inertia about each link COM, link frame (diagonals)
LINK_INERTIAS = _f32((
    np.diag((4.7e-4, 8.1e-4, 5.5e-4)),    # hip
    np.diag((5.5e-3, 5.1e-3, 1.4e-3)),    # thigh
    np.diag((4.2e-3, 4.2e-3, 3.3e-5)),    # calf+foot
))
THIGH_COM = _f32((0.0, 0.0223, -0.03))   # y mirrored per side
CALF_COM = _f32((0.0, 0.0, -0.146))

JOINT_DAMPING = 0.01     # N m s / rad, URDF-style viscous joint damping
TORQUE_LIMIT = 33.5      # N m, A1 URDF actuator effort limit: Gazebo and
                         # Isaac clamp commanded efforts at the joint, so
                         # the plant must too
NU = 6 + 3 * NUM_LEG     # 18 generalized velocities
NC = 3 * NUM_LEG         # 12 contact constraint rows


@tensorclass
class JointPlantState:
    root_pos: torch.Tensor       # (B,3) world
    root_quat: torch.Tensor      # (B,4) w,x,y,z
    root_lin_vel: torch.Tensor   # (B,3) world
    root_ang_vel: torch.Tensor   # (B,3) world
    joint_pos: torch.Tensor      # (B,12)
    joint_vel: torch.Tensor      # (B,12)
    foot_pos: torch.Tensor       # (B,4,3) world (FK cache)
    foot_vel: torch.Tensor       # (B,4,3) world
    in_contact: torch.Tensor     # (B,4) bool
    pin_anchor: torch.Tensor     # (B,4,3) world pin points
    foot_force_n: torch.Tensor   # (B,4) constraint normal force (sensor)


def _c(values, like: torch.Tensor) -> torch.Tensor:
    return const(values, like.dtype, like.device)


def _mat(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _mv(m, v):
    """Matrix-vector product over leading axes."""
    return (m @ v[..., None])[..., 0]


def _leg_links(q, rho_fix):
    """Trunk-frame link quantities of legs at joint angles ``q`` (..., 3):
    (coms (..., 3, 3), rots (..., 3, 3, 3), axes (..., 3, 3), origins
    (..., 3, 3)): per link (hip, thigh, calf) its COM and orientation,
    and per joint (hip roll, hip pitch, knee) its axis and a point on it.
    The chain is ``models/kinematics.py``'s: hip roll about +x at the
    mount, hip and knee pitch about +y after it; link k turns about
    joint k's axis through joint k's point."""
    ox, oy, d, lu = (rho_fix[..., i] for i in range(4))
    side = torch.sign(d)
    s0, c0 = torch.sin(q[..., 0]), torch.cos(q[..., 0])
    s1, c1 = torch.sin(q[..., 1]), torch.cos(q[..., 1])
    q12 = q[..., 1] + q[..., 2]
    s12, c12 = torch.sin(q12), torch.cos(q12)
    one, zero = torch.ones_like(s0), torch.zeros_like(s0)
    rx0 = _mat(((one, zero, zero), (zero, c0, -s0), (zero, s0, c0)))
    r_thigh = rx0 @ _mat(((c1, zero, s1), (zero, one, zero),
                          (-s1, zero, c1)))
    r_calf = rx0 @ _mat(((c12, zero, s12), (zero, one, zero),
                         (-s12, zero, c12)))

    h0 = torch.stack([ox, oy, zero], dim=-1)
    ax = torch.stack([zero, c0, s0], dim=-1)            # Rx(q0) e_y
    o1 = h0 + ax * d[..., None]
    o2 = o1 - r_thigh[..., :, 2] * lu[..., None]
    com_hip = h0 + ax * (0.4 * d)[..., None]
    thigh = _c(THIGH_COM, q) * torch.stack([one, side, one], dim=-1)
    com_thigh = o1 + _mv(r_thigh, thigh)
    com_calf = o2 + _mv(r_calf, _c(CALF_COM, q).expand_as(thigh))
    ex = torch.stack([one, zero, zero], dim=-1)
    return (torch.stack([com_hip, com_thigh, com_calf], dim=-2),
            torch.stack([rx0, r_thigh, r_calf], dim=-3),
            torch.stack([ex, ax, ax], dim=-2),
            torch.stack([h0, o1, o2], dim=-2))


def _leg_kin(q, qd, rho_fix):
    """Legs' dynamic quantities at joint angles ``q`` and rates ``qd``
    (..., 3): link positions, their joint derivatives and the
    velocity-product (bias) terms, and the foot point's (at
    rho_opt = 0).

    Closed forms of the JAX module's ``jax.jacfwd`` / ``jax.jvp``: a point
    p on link k moves with joint j <= k as a_j x (p - o_j) (axis a_j
    through o_j); the bias acceleration along the flow is
    sum_j [da_j x (p - o_j) + a_j x (dp - do_j)] qd_j, where joint j's axis
    and point ride on link j - 1 (da_j = sum_{i<j} a_i x a_j qd_i, do_j =
    sum_{i<j} a_i x (o_j - o_i) qd_i). ``tests/test_torch_joint_plant.py``
    holds them to ``torch.func`` derivatives of :func:`_leg_links`."""
    coms, rots, axes, origins = _leg_links(q, rho_fix)
    cross = torch.linalg.cross
    # [k, j] = 1 where link k moves with joint j (j <= k), where joint k's
    # axis and point ride on joint j (j < k), for the foot (every j)
    tri = _c(((1.0, 0.0, 0.0), (1.0, 1.0, 0.0), (1.0, 1.0, 1.0)), q)[..., None]
    strict = _c(((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (1.0, 1.0, 0.0)),
                q)[..., None]
    foot = _c(((1.0, 1.0, 1.0),), q)[..., None]
    a_j = axes[..., None, :, :]                        # (..., 1, joint, 3)

    def columns(p):
        """a_j x (p_k - o_j): (..., point k, joint j, 3)."""
        return cross(a_j, p[..., :, None, :] - origins[..., None, :, :])

    rate = lambda cols: torch.einsum("...kja,...j->...ka", cols, qd)
    jcols = columns(coms) * tri                         # (..., link, joint, 3)
    cdot = rate(jcols)
    odot = rate(columns(origins) * strict)              # joint points
    adot = rate(cross(a_j, axes[..., :, None, :]) * strict)   # joint axes

    def bias(p, pdot, mask):
        """sum_j [da_j x (p - o_j) + a_j x (dp - do_j)] qd_j over j in
        ``mask`` of each point p (..., k, 3)."""
        return rate((cross(adot[..., None, :, :],
                           p[..., :, None, :] - origins[..., None, :, :])
                     + cross(a_j, pdot[..., :, None, :]
                             - odot[..., None, :, :])) * mask)

    jw_cols = axes[..., None, :, :] * tri               # (..., link, joint, 3)
    zero = torch.zeros_like(q)
    p_f = kin.fk(q, zero, rho_fix)
    j_f = kin.jac(q, zero, rho_fix)
    pdot_f = _mv(j_f, qd)
    return dict(coms=coms, rots=rots, dcom_dq=jcols.transpose(-1, -2),
                jw_cols=jw_cols, omega_rel=rate(jw_cols), cdot=cdot,
                cddot0=bias(coms, cdot, tri),
                omdot0=rate(adot[..., None, :, :] * tri),
                p_f=p_f, j_f=j_f, pdot_f=pdot_f,
                pddot0_f=bias(p_f[..., None, :], pdot_f[..., None, :],
                              foot)[..., 0, :])


def _rotate(rot, v):
    """R v for vectors v (B, n, 3) by rotations rot (B, 3, 3)."""
    return torch.einsum("bij,blj->bli", rot, v)


def _dynamics_terms(params: RobotParams, rot: torch.Tensor, qj: torch.Tensor,
                    u: torch.Tensor):
    """Mass matrix M (B,18,18), bias + gravity b (B,18), foot Jacobians
    Jc (B,4,3,18) (world), foot bias accelerations (B,4,3), foot world
    velocities (B,4,3) and foot positions relative to the root (B,4,3,
    world). ``rot`` is the trunk rotation (B,3,3), ``qj`` (B,4,3)."""
    bsz = u.shape[0]
    vb, wb = u[:, :3], u[:, 3:6]
    lk = _leg_kin(qj, u[:, 6:].reshape(bsz, NUM_LEG, 3), params.rho_fix)
    # per-link quantities over (leg, link) flattened to 12
    flat = lambda x: x.reshape((bsz, NUM_LEG * 3) + x.shape[3:])
    coms, rots_l, dcom = flat(lk["coms"]), flat(lk["rots"]), \
        flat(lk["dcom_dq"])
    jw_cols, om_rel = flat(lk["jw_cols"]), flat(lk["omega_rel"])
    cdot, cddot0, omdot0 = flat(lk["cdot"]), flat(lk["cddot0"]), \
        flat(lk["omdot0"])

    rc = _rotate(rot, coms)                      # R c, (B,12,3) world
    rcd = _rotate(rot, cdot)
    masses = _c(LINK_MASSES, u).repeat(NUM_LEG)  # (12,)
    wb_ = wb[:, None, :]

    # --- Jacobians (B,12,3,18): [I | -skew(Rc) | R dcom/dq in leg cols]
    eye3 = torch.eye(3, dtype=u.dtype, device=u.device)
    onehot = torch.eye(NUM_LEG, dtype=u.dtype, device=u.device
                       ).repeat_interleave(3, dim=0)              # (12,4)
    jv_joint = torch.einsum("bac,blcj,lk->blakj", rot, dcom, onehot)
    jw_joint = torch.einsum("bac,bljc,lk->blakj", rot, jw_cols, onehot)
    eye_l = eye3.expand(bsz, NUM_LEG * 3, 3, 3)
    jv = torch.cat([eye_l, -mathx.skew(rc),
                    jv_joint.reshape(bsz, NUM_LEG * 3, 3, NC)], dim=3)
    jw = torch.cat([torch.zeros_like(eye_l), eye_l,
                    jw_joint.reshape(bsz, NUM_LEG * 3, 3, NC)], dim=3)

    # world link rotational inertias
    rl_w = torch.einsum("bac,blcd->blad", rot, rots_l)
    inertia = _c(LINK_INERTIAS, u).repeat(NUM_LEG, 1, 1)          # (12,3,3)
    iw = torch.einsum("zlab,lbc,zldc->zlad", rl_w, inertia, rl_w)

    # --- mass matrix
    trunk_mass = torch.clamp(params.robot_mass - NUM_LEG * LEG_MASS,
                             min=1.0)
    i_tr_w = rot @ params.trunk_inertia @ rot.transpose(1, 2)
    m_mat = (torch.einsum("l,blai,blaj->bij", masses, jv, jv)
             + torch.einsum("zlai,zlab,zlbj->zij", jw, iw, jw))
    m_mat[:, :3, :3] += trunk_mass[:, None, None] * eye3
    m_mat[:, 3:6, 3:6] += i_tr_w

    # --- bias forces (u_dot = 0 velocity products) + gravity
    grav = _c(GRAV, u)
    om_rel_w = _rotate(rot, om_rel)
    w_link = wb_ + om_rel_w                                       # (B,12,3)
    cross = torch.linalg.cross
    a0 = (cross(wb_, cross(wb_, rc)) + 2.0 * cross(wb_, rcd)
          + _rotate(rot, cddot0))
    alpha0 = cross(wb_, om_rel_w) + _rotate(rot, omdot0)
    gyro = (torch.einsum("zlab,zlb->zla", iw, alpha0)
            + cross(w_link, torch.einsum("zlab,zlb->zla", iw, w_link)))
    grav_f = masses[:, None] * grav[None, :]
    b = (torch.einsum("blai,bla->bi", jv, masses[:, None] * a0 - grav_f)
         + torch.einsum("blai,bla->bi", jw, gyro))
    b[:, 3:6] += cross(wb, torch.einsum("bij,bj->bi", i_tr_w, wb))
    b[:, :3] += -trunk_mass[:, None] * grav

    # --- foot contact rows
    p_f_w = _rotate(rot, lk["p_f"])                         # (B,4,3)
    jc_joint = torch.einsum("bac,blcj,lk->blakj", rot, lk["j_f"],
                            torch.eye(NUM_LEG, dtype=u.dtype,
                                      device=u.device))
    eye_f = eye3.expand(bsz, NUM_LEG, 3, 3)
    jc = torch.cat([eye_f, -mathx.skew(p_f_w),
                    jc_joint.reshape(bsz, NUM_LEG, 3, NC)], dim=3)
    pdot_f_w = _rotate(rot, lk["pdot_f"])
    a0_f = (cross(wb_, cross(wb_, p_f_w)) + 2.0 * cross(wb_, pdot_f_w)
            + _rotate(rot, lk["pddot0_f"]))
    v_f = vb[:, None, :] + cross(wb_, p_f_w) + pdot_f_w
    return m_mat, b, jc, a0_f, v_f, p_f_w


def init_standing(params: RobotParams, terrain: terrain_mod.Terrain,
                  height: float = 0.3, dtype=torch.float32,
                  device=CUDA) -> JointPlantState:
    """Robots standing at the default stance, feet pinned on the terrain;
    ``params`` and ``terrain`` batched. The pose is ``sim.plant``'s."""
    ps = plant_mod.init_standing(params, terrain, height, dtype, device)
    b = ps.root_pos.shape[0]
    return JointPlantState(
        root_pos=ps.root_pos, root_quat=ps.root_quat,
        root_lin_vel=ps.root_lin_vel, root_ang_vel=ps.root_ang_vel,
        joint_pos=ps.joint_pos,
        joint_vel=ps.joint_pos.new_zeros((b, NC)),
        foot_pos=ps.foot_pos, foot_vel=ps.foot_vel,
        in_contact=ps.in_contact, pin_anchor=ps.foot_pos,
        foot_force_n=torch.full_like(ps.foot_force_n, 0.25 * 13.0 * 9.81))


def _substep(params: RobotParams, terrain: terrain_mod.Terrain,
             ps: JointPlantState, tau: torch.Tensor, dt: torch.Tensor
             ) -> tuple[JointPlantState, torch.Tensor]:
    """One physics substep under joint torques ``tau`` (B,12). Returns the
    new state and the solve's ``info`` (B,), nonzero where the KKT
    system was singular (read by the caller)."""
    bsz = ps.root_pos.shape[0]
    rot = mathx.quat_to_rot(ps.root_quat)
    qj = ps.joint_pos.reshape(bsz, NUM_LEG, 3)
    u = torch.cat([ps.root_lin_vel, ps.root_ang_vel, ps.joint_vel], dim=1)

    m_mat, b, jc, a0_f, v_f, p_f_w = _dynamics_terms(params, rot, qj, u)
    foot_w = ps.root_pos[:, None, :] + p_f_w

    # --- contact transitions
    gz = terrain_mod.height(terrain, foot_w[..., 0], foot_w[..., 1])
    touchdown = ((~ps.in_contact) & (foot_w[..., 2] <= gz)
                 & (v_f[..., 2] <= 0.0))
    in_contact = ps.in_contact | touchdown
    anchor = torch.where(touchdown[..., None],
                         torch.cat([foot_w[..., :2], gz[..., None]], dim=-1),
                         ps.pin_anchor)

    # --- masked symmetric KKT [[M, Jc'], [Jc, -D]]: free feet get zeroed
    # rows and a unit dual diagonal (lambda = 0), static shapes
    cmask = in_contact.repeat_interleave(3, dim=1)                # (B,12)
    jc_flat = torch.where(cmask[..., None], jc.reshape(bsz, NC, NU), 0.0)
    dual_d = torch.where(cmask, u.new_full((), 1e-8), u.new_ones(()))
    kkt = torch.cat([torch.cat([m_mat, jc_flat.transpose(1, 2)], dim=2),
                     torch.cat([jc_flat, -torch.diag_embed(dual_d)], dim=2)],
                    dim=1)

    tau_act = torch.clamp(tau, -TORQUE_LIMIT, TORQUE_LIMIT)
    tau_gen = torch.cat([u.new_zeros((bsz, 6)),
                         tau_act - JOINT_DAMPING * ps.joint_vel], dim=1)
    # Baumgarte position stabilization on the pin anchors (critically
    # damped, omega ~ 0.1/dt: gentle next to the per-substep velocity
    # projection below, which keeps Jc u ~ 0 anyway)
    omega_s = 0.1 / dt
    phi = foot_w - anchor
    stab = (2.0 * omega_s * v_f + (omega_s ** 2) * phi).reshape(bsz, NC)
    rhs_acc = torch.cat([tau_gen - b,
                         torch.where(cmask, -(a0_f.reshape(bsz, NC) + stab),
                                     0.0)], dim=1)
    # inelastic impulse projection (Jc u+ = 0): same KKT, second RHS
    rhs_imp = torch.cat([torch.einsum("bij,bj->bi", m_mat, u),
                         u.new_zeros((bsz, NC))], dim=1)
    sol, info = torch.linalg.solve_ex(
        kkt, torch.stack([rhs_acc, rhs_imp], dim=2))
    udot, nu_acc, u_proj = sol[:, :NU, 0], sol[:, NU:, 0], sol[:, :NU, 1]
    lam = -nu_acc.reshape(bsz, NUM_LEG, 3)          # world constraint force

    # the ground can only push: release feet whose normal force went
    # negative
    release = in_contact & (lam[..., 2] < 0.0)
    fn = torch.where(in_contact & ~release,
                     torch.clamp(lam[..., 2], min=0.0), 0.0)
    in_contact = in_contact & ~release

    # --- semi-implicit Euler on the projected velocity
    u_new = u_proj + dt * udot
    vb, wb, qd = u_new[:, :3], u_new[:, 3:6], u_new[:, 6:]
    root_pos = ps.root_pos + dt * vb
    root_quat = plant_mod._quat_integrate(ps.root_quat, wb, dt)
    joint_pos = ps.joint_pos + dt * qd

    # FK caches for the next substep and the sensors
    rot2 = mathx.quat_to_rot(root_quat)
    q_legs = joint_pos.reshape(bsz, NUM_LEG, 3)
    p_rel = _rotate(rot2, kin.fk(q_legs, params.rho_opt, params.rho_fix))
    jacs = kin.jac(q_legs, params.rho_opt, params.rho_fix)
    rel_vel = torch.einsum("blij,blj->bli", jacs,
                           qd.reshape(bsz, NUM_LEG, 3))
    foot_vel = (vb[:, None, :] + torch.linalg.cross(wb[:, None, :], p_rel)
                + _rotate(rot2, rel_vel))
    return ps.replace(
        root_pos=root_pos, root_quat=root_quat, root_lin_vel=vb,
        root_ang_vel=wb, joint_pos=joint_pos, joint_vel=qd,
        foot_pos=root_pos[:, None, :] + p_rel, foot_vel=foot_vel,
        in_contact=in_contact, pin_anchor=anchor, foot_force_n=fn), info


def plant_step(params: RobotParams, terrain: terrain_mod.Terrain,
               ps: JointPlantState, joint_torques: torch.Tensor,
               dt: torch.Tensor, substeps: int = 10) -> JointPlantState:
    """Advance one control period under constant joint torques (B, 12).
    The substeps' solve statuses are read once, at the end (one host
    read, ``tensors.host_syncs``): a singular KKT system raises."""
    sub_dt = dt / substeps
    failed = None
    for _ in range(substeps):
        ps, info = _substep(params, terrain, ps, joint_torques, sub_dt)
        failed = info != 0 if failed is None else failed | (info != 0)
    if host_bool(torch.any(failed)):
        raise torch.linalg.LinAlgError(
            "joint plant: singular contact KKT system in scenarios "
            f"{torch.nonzero(failed).flatten().tolist()}")
    return ps


def read_sensors(params: RobotParams, ps: JointPlantState,
                 prev_root_lin_vel: torch.Tensor,
                 dt: torch.Tensor) -> SensorData:
    """Sensor snapshot: joint encoders are direct state here (no IK)."""
    rot = mathx.quat_to_rot(ps.root_quat)
    acc_world = (ps.root_lin_vel - prev_root_lin_vel) / dt
    imu_acc = torch.einsum("bji,bj->bi", rot, acc_world - _c(GRAV, rot))
    imu_gyro = torch.einsum("bji,bj->bi", rot, ps.root_ang_vel)
    return SensorData(
        root_quat=ps.root_quat, root_pos=ps.root_pos,
        root_lin_vel=ps.root_lin_vel, imu_acc=imu_acc,
        imu_ang_vel=imu_gyro, joint_pos=ps.joint_pos,
        joint_vel=ps.joint_vel, foot_force=ps.foot_force_n)
