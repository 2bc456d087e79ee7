"""Single-rigid-body MPC model (counterpart of ``models/srb.py``, MPC
path): continuous dynamics, forward-Euler discretization, the condensed
horizon QP and the shared friction-cone basis, batched over scenarios.

Reference quirks kept on purpose: forward-Euler discretization, one B
for the whole horizon, current contacts gating every horizon step's
bounds, and the factor-2 Q/R convention.

State (13): [roll,pitch,yaw, x,y,z, wx,wy,wz, vx,vy,vz, g]; decision
variables: 12 world-frame ground-reaction forces per horizon step.
"""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.config import (
    MPC_STATE_DIM, NUM_DOF, NUM_LEG, PLAN_HORIZON,
)
from a1_qp_mpc_controller_tpu_torch.ops import qp as qpx
from a1_qp_mpc_controller_tpu_torch.tensors import const, tree_map
from a1_qp_mpc_controller_tpu_torch.utils import mathx
from a1_qp_mpc_controller_tpu_torch.utils.mathx import skew


def tile_last(x: torch.Tensor, reps: int) -> torch.Tensor:
    """``jnp.tile`` along the last axis."""
    return x.repeat(*([1] * (x.ndim - 1)), reps)


def continuous_a(root_euler: torch.Tensor) -> torch.Tensor:
    """A_c (..., 13, 13): yaw-only angular-velocity-to-rpy-rate map,
    velocity -> position, gravity channel."""
    cy, sy = torch.cos(root_euler[..., 2]), torch.sin(root_euler[..., 2])
    a = root_euler.new_zeros(root_euler.shape[:-1]
                             + (MPC_STATE_DIM, MPC_STATE_DIM))
    a[..., 0, 6], a[..., 0, 7] = cy, sy
    a[..., 1, 6], a[..., 1, 7] = -sy, cy
    a[..., 2, 8] = 1.0
    for i in range(3):
        a[..., 3 + i, 9 + i] = 1.0
    a[..., 11, 12] = 1.0
    return a


def continuous_b(robot_mass: torch.Tensor, trunk_inertia: torch.Tensor,
                 root_rot_mat: torch.Tensor,
                 foot_pos: torch.Tensor) -> torch.Tensor:
    """B_c (..., 13, 12); ``foot_pos`` (..., 4, 3) world-aligned
    body-centered."""
    inertia_world = root_rot_mat @ trunk_inertia @ root_rot_mat.transpose(
        -1, -2)
    inv_inertia = mathx.inv3(inertia_world)
    torque_blocks = torch.einsum("...ab,...lbc->...lac", inv_inertia,
                                 skew(foot_pos))        # (..., 4, 3, 3)
    eye = torch.eye(3, dtype=foot_pos.dtype, device=foot_pos.device)
    force_block = eye / robot_mass[..., None, None]
    b = foot_pos.new_zeros(foot_pos.shape[:-2] + (MPC_STATE_DIM, NUM_DOF))
    for i in range(NUM_LEG):
        b[..., 6:9, 3 * i:3 * i + 3] = torque_blocks[..., i, :, :]
        b[..., 9:12, 3 * i:3 * i + 3] = force_block
    return b


def discretize(a_c: torch.Tensor, b_c: torch.Tensor, dt: torch.Tensor):
    """Forward Euler: A_d = I + A_c dt, B_d = B_c dt."""
    eye = torch.eye(MPC_STATE_DIM, dtype=a_c.dtype, device=a_c.device)
    return eye + a_c * dt, b_c * dt


def a_d_powers(a_c: torch.Tensor, dt: torch.Tensor, horizon: int
               ) -> torch.Tensor:
    """(..., H+1, 13, 13) stack of A_d^k in closed form (A_c is
    nilpotent of index 3)."""
    k = torch.arange(horizon + 1, dtype=a_c.dtype,
                     device=a_c.device)[:, None, None]
    a_c2 = a_c @ a_c
    eye = torch.eye(MPC_STATE_DIM, dtype=a_c.dtype, device=a_c.device)
    return (eye + k * dt * a_c.unsqueeze(-3)
            + (k * (k - 1.0) / 2.0) * dt * dt * a_c2.unsqueeze(-3))


def _toeplitz_index(horizon: int, max_lag: int, dtype, device):
    i_idx = torch.arange(horizon, device=device)[:, None]
    j_idx = torch.arange(horizon, device=device)[None, :]
    lag = torch.clamp(i_idx - j_idx, 0, max_lag)
    mask = (i_idx >= j_idx).to(dtype)[:, :, None, None]
    return lag, mask


def _place(blocks: torch.Tensor, horizon: int) -> torch.Tensor:
    """(..., H, H, n, m) blocks -> (..., H*n, H*m)."""
    n, m = blocks.shape[-2:]
    return blocks.transpose(-3, -2).reshape(
        blocks.shape[:-4] + (horizon * n, horizon * m))


def condense(a_c: torch.Tensor, b_d_list: torch.Tensor, dt: torch.Tensor,
             horizon: int = PLAN_HORIZON):
    """A_qp (..., H*13, 13), B_qp (..., H*13, H*12) with per-step
    ``b_d_list`` (..., H, 13, 12)."""
    n = MPC_STATE_DIM
    powers = a_d_powers(a_c, dt, horizon)
    a_qp = powers[..., 1:, :, :].reshape(powers.shape[:-3] + (horizon * n, n))
    lag, mask = _toeplitz_index(horizon, horizon, a_c.dtype, a_c.device)
    toeplitz = powers[..., lag, :, :]                  # (..., H, H, n, n)
    blocks = torch.einsum("...ijab,...jbc->...ijac", toeplitz * mask,
                          b_d_list)
    return a_qp, _place(blocks, horizon)


def condense_same_b(a_c: torch.Tensor, b_d: torch.Tensor, dt: torch.Tensor,
                    horizon: int = PLAN_HORIZON):
    """Production case, one B_d for the whole horizon: B_qp is
    block-Toeplitz in M_k = A_d^k B_d."""
    n = MPC_STATE_DIM
    powers = a_d_powers(a_c, dt, horizon)
    a_qp = powers[..., 1:, :, :].reshape(powers.shape[:-3] + (horizon * n, n))
    m_blocks = torch.einsum("...kab,...bc->...kac",
                            powers[..., :horizon, :, :], b_d)
    lag, mask = _toeplitz_index(horizon, horizon - 1, a_c.dtype, a_c.device)
    return a_qp, _place(m_blocks[..., lag, :, :] * mask, horizon)


def mpc_cost(a_qp: torch.Tensor, b_qp: torch.Tensor, q_weights: torch.Tensor,
             r_weights: torch.Tensor, mpc_states: torch.Tensor,
             mpc_states_d: torch.Tensor, horizon: int = PLAN_HORIZON,
             contacts: torch.Tensor | None = None):
    """P = B'QB + R, q = B'Q(A x0 - x_ref) with Q = 2 diag(q_w), R = 2
    diag(r_w); ``contacts`` applies swing-variable elimination by
    masking B_qp columns."""
    q_diag = 2.0 * tile_last(q_weights, horizon)
    r_diag = 2.0 * tile_last(r_weights, horizon)
    if contacts is not None:
        sf = tile_last(contacts.repeat_interleave(3, dim=-1),
                       horizon).to(b_qp.dtype)
        b_qp = b_qp * sf[..., None, :]
        r_diag = r_diag * sf + (1.0 - sf)
    bq = b_qp * q_diag[..., :, None]
    p_mat = b_qp.transpose(-1, -2) @ bq + torch.diag_embed(r_diag)
    resid = (a_qp @ mpc_states[..., None])[..., 0] - mpc_states_d
    q_vec = (bq.transpose(-1, -2) @ resid[..., None])[..., 0]
    return p_mat, q_vec


def friction_basis_blocks(dtype, device):
    """The (5, 3) per-(step, leg) blocks: A(mu) is block-diagonal with
    copies of ``base + mu * slope``."""
    base = const(((1.0, 0, 0), (1.0, 0, 0), (0, 1.0, 0), (0, 1.0, 0),
                  (0, 0, 1.0)), dtype, device)
    slope = const(((0, 0, 1.0), (0, 0, -1.0), (0, 0, 1.0), (0, 0, -1.0),
                   (0, 0, 0)), dtype, device)
    return base, slope


def friction_constraint_matrix(mu: torch.Tensor, horizon: int = PLAN_HORIZON
                               ) -> torch.Tensor:
    """(..., H*20, H*12) constraint matrix for per-scenario ``mu``."""
    base, slope = friction_basis_blocks(mu.dtype, mu.device)
    leg = base + mu[..., None, None] * slope              # (..., 5, 3)
    n_blk = horizon * NUM_LEG
    eye = torch.eye(n_blk, dtype=mu.dtype, device=mu.device)
    mat = torch.einsum("...ij,tu->...tiuj", leg, eye)
    return mat.reshape(mu.shape + (n_blk * 5, n_blk * 3))


def friction_constraint_basis_nblk(n_blk: int, dtype, device):
    """Shared A0, A1 with A(mu) = A0 + mu * A1 for ``n_blk`` blocks."""
    base, slope = friction_basis_blocks(dtype, device)
    eye = torch.eye(n_blk, dtype=dtype, device=device)
    return torch.kron(eye, base), torch.kron(eye, slope)


def friction_constraint_basis(horizon: int, dtype, device):
    return friction_constraint_basis_nblk(horizon * NUM_LEG, dtype, device)


def mpc_bounds(contacts: torch.Tensor, fz_min: torch.Tensor,
               fz_max: torch.Tensor, horizon: int = PLAN_HORIZON):
    """(..., H*20) bounds; the current contacts gate every step."""
    c = contacts.to(fz_min.dtype)
    zero = torch.zeros_like(c)
    inf = torch.full_like(c, float("inf"))
    lb_leg = torch.stack([zero, -inf, zero, -inf, fz_min[..., None] * c],
                         dim=-1)
    ub_leg = torch.stack([inf, zero, inf, zero, fz_max[..., None] * c],
                         dim=-1)
    flat = lambda t: tile_last(t.reshape(t.shape[:-2] + (-1,)), horizon)
    return flat(lb_leg), flat(ub_leg)


def reference_mpc_problem(params, horizon: int = PLAN_HORIZON):
    """Representative MPC instance per scenario (nominal stand, all feet
    in contact) for precomputing solver state."""
    mass = params.robot_mass
    dtype, dev = mass.dtype, mass.device
    bshape = mass.shape
    euler = mass.new_zeros(bshape + (3,))
    rot = torch.eye(3, dtype=dtype, device=dev).expand(bshape + (3, 3))
    dt = torch.tensor(0.0025, dtype=dtype, device=dev)
    a_c = continuous_a(euler)
    b_c = continuous_b(mass, params.trunk_inertia, rot,
                       params.default_foot_pos)
    _, b_d = discretize(a_c, b_c, dt)
    b_d_list = b_d.unsqueeze(-3).expand(bshape + (horizon,) + b_d.shape[-2:])
    a_qp, b_qp = condense(a_c, b_d_list, dt, horizon)
    x0 = mass.new_zeros(bshape + (MPC_STATE_DIM,))
    x0[..., 5] = 0.3
    x0[..., 12] = -9.8
    x_ref = tile_last(x0, horizon)
    p_mat, q_vec = mpc_cost(a_qp, b_qp, params.q_weights, params.r_weights,
                            x0, x_ref, horizon)
    a_mat = friction_constraint_matrix(params.mu_mpc, horizon)
    all_contact = torch.ones(bshape + (NUM_LEG,), dtype=torch.bool,
                             device=dev)
    lb, ub = mpc_bounds(all_contact, params.fz_min, params.fz_max, horizon)
    return p_mat, q_vec, a_mat, lb, ub


def reference_mpc_scaling(params, horizon: int = PLAN_HORIZON
                          ) -> qpx.Scaling:
    """Ruiz equilibration (10 sweeps) of :func:`reference_mpc_problem`:
    the MPC family's scaling, computed once from the representative
    instance (leading axes of ``params`` kept)."""
    return qpx.compute_scaling(*reference_mpc_problem(params, horizon), 10)


def reference_kkt_inverse(params, scaling: qpx.Scaling, rho: float,
                          horizon: int = PLAN_HORIZON,
                          eq_scale: float = 1.0) -> torch.Tensor:
    """Exact scaled-KKT inverse (B, n, n) at each scenario's
    representative instance: the seed for a Newton-Schulz solve
    (``ops/qp.newton_schulz_inverse``), one inverse at init and none in
    the hot path. ``params`` and ``scaling`` batched (B,)."""
    p_mat, q_vec, a_mat, lb, ub = reference_mpc_problem(params, horizon)
    sp = qpx.apply_scaling(p_mat, q_vec, a_mat, lb, ub, scaling)
    rho_b = torch.full_like(params.robot_mass, rho)
    return qpx._kkt_inverse(sp.P, sp.A, qpx._rho_vec(sp.l, sp.u, rho_b,
                                                     eq_scale), 1e-6)


def eliminate_swing(p_mat, q_vec, lb, ub, contacts, horizon: int):
    """Swing-leg variable elimination (static-shape mask form): zero the
    swing rows/columns of P (unit diagonal), zero their q entries and
    loosen their constraint rows. Same optimum, no equality rows."""
    s_var = tile_last(contacts.repeat_interleave(3, dim=-1), horizon)
    s_row = tile_last(contacts.repeat_interleave(5, dim=-1), horizon)
    sf = s_var.to(p_mat.dtype)
    p2 = (p_mat * (sf[..., :, None] * sf[..., None, :])
          + torch.diag_embed(1.0 - sf))
    q2 = q_vec * sf
    lb2 = torch.where(s_row, lb, -float("inf"))
    ub2 = torch.where(s_row, ub, float("inf"))
    return p2, q2, lb2, ub2


def contact_patterns(device) -> torch.Tensor:
    """(16, 4) bool table of all contact patterns; row id =
    contacts . [8, 4, 2, 1]."""
    bits = (torch.arange(16, device=device)[:, None]
            // torch.tensor([8, 4, 2, 1], device=device)[None, :]) % 2
    return bits.to(torch.bool)


def reference_mpc_scaling_table(params, horizon: int = PLAN_HORIZON,
                                chunk: int = 64) -> qpx.Scaling:
    """Per-scenario, per-contact-pattern Ruiz equilibration: Scaling with
    d (B,16,n), e (B,16,m), c (B,16). Built ``chunk`` scenarios at a time
    to bound the (chunk*16, 200, 120) working set."""
    b = params.robot_mass.shape[0]
    pats = contact_patterns(params.robot_mass.device)
    parts = []
    for s in range(0, b, chunk):
        sub = tree_map(lambda v: v[s:s + chunk], params)
        p_mat, q_vec, a_mat, lb, ub = reference_mpc_problem(sub, horizon)
        nb = p_mat.shape[0]
        ex = lambda t: t.unsqueeze(1).expand((nb, 16) + t.shape[1:])
        p2, q2, l2, u2 = eliminate_swing(
            ex(p_mat), ex(q_vec), ex(lb), ex(ub),
            pats.expand(nb, 16, NUM_LEG), horizon)
        flat = lambda t: t.reshape((nb * 16,) + t.shape[2:])
        sc = qpx.compute_scaling(flat(p2), flat(q2), flat(ex(a_mat)),
                                 flat(l2), flat(u2), 10)
        parts.append(qpx.Scaling(d=sc.d.reshape(nb, 16, -1),
                                 e=sc.e.reshape(nb, 16, -1),
                                 c=sc.c.reshape(nb, 16)))
    return qpx.Scaling(d=torch.cat([p.d for p in parts]),
                       e=torch.cat([p.e for p in parts]),
                       c=torch.cat([p.c for p in parts]))


def build_reference_trajectory(root_euler, root_pos, root_pos_d,
                               root_euler_d, root_ang_vel_d,
                               root_lin_vel_d_world, dt,
                               horizon: int = PLAN_HORIZON) -> torch.Tensor:
    """(..., H*13) desired state trajectory (A1RobotControl.cpp:470-488)."""
    steps = torch.arange(1, horizon + 1, dtype=root_euler.dtype,
                         device=root_euler.device) * dt          # (H,)
    ones = torch.ones_like(steps)
    col = lambda v: v[..., None] * ones
    ramp = lambda base, rate: base[..., None] + rate[..., None] * steps
    unit = torch.ones_like(root_pos[..., 0])
    traj = torch.stack([
        col(root_euler_d[..., 0]), col(root_euler_d[..., 1]),
        ramp(root_euler[..., 2], root_ang_vel_d[..., 2]),
        ramp(root_pos[..., 0], root_lin_vel_d_world[..., 0]),
        ramp(root_pos[..., 1], root_lin_vel_d_world[..., 1]),
        col(root_pos_d[..., 2]),
        col(root_ang_vel_d[..., 0]), col(root_ang_vel_d[..., 1]),
        col(root_ang_vel_d[..., 2]),
        col(root_lin_vel_d_world[..., 0]), col(root_lin_vel_d_world[..., 1]),
        0.0 * col(unit),
        -9.8 * col(unit),
    ], dim=-1)                                                   # (..., H, 13)
    return traj.reshape(traj.shape[:-2] + (-1,))
