"""A1 leg kinematics (counterpart of ``models/kinematics.py``): closed-form
FK, its closed-form Jacobian (the JAX package takes it with
``jax.jacfwd``), the calibration derivatives ``dfk_drho``, ``dJ_dq`` and
``dJ_drho`` (``torch.func.jacfwd`` of those closed forms, as the JAX
package takes them with ``jax.jacfwd``), the per-pose fan-out and
damped-Newton IK. Every function broadcasts over leading axes (legs,
scenarios).

Chain per leg: p(q) = [ox, oy, 0] + Rx(q0) ([0, d, 0] + Ry(q1) ([0, 0, -lu]
+ Ry(q2) [cx, cy, cz - ll])), rho_fix = (ox, oy, d, lu, ll),
rho_opt = (cx, cy, cz).
"""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.tensors import const
from a1_qp_mpc_controller_tpu_torch.utils import mathx


def _terms(q, rho_opt, rho_fix):
    ox, oy, d, lu, ll = (rho_fix[..., i] for i in range(5))
    cx, cy, cz = rho_opt[..., 0], rho_opt[..., 1], rho_opt[..., 2]
    s0, c0 = torch.sin(q[..., 0]), torch.cos(q[..., 0])
    s1, c1 = torch.sin(q[..., 1]), torch.cos(q[..., 1])
    s12, c12 = torch.sin(q[..., 1] + q[..., 2]), torch.cos(q[..., 1] + q[..., 2])
    # foot point in the calf frame, then the upper leg in the hip-pitch
    # frame (y unchanged by Ry)
    fx = cx * c12 + (cz - ll) * s12
    fz = -cx * s12 + (cz - ll) * c12
    hx = fx - lu * s1
    hy = cy + d
    hz = fz - lu * c1
    return ox, oy, lu, s0, c0, s1, c1, fx, fz, hx, hy, hz


def fk(q: torch.Tensor, rho_opt: torch.Tensor, rho_fix: torch.Tensor
       ) -> torch.Tensor:
    """Joint angles (..., 3) -> foot position (..., 3), body frame."""
    ox, oy, _, s0, c0, _, _, _, _, hx, hy, hz = _terms(q, rho_opt, rho_fix)
    px = ox + hx
    py = oy + c0 * hy - s0 * hz
    pz = s0 * hy + c0 * hz
    return torch.stack([px, py, pz], dim=-1)


def jac(q: torch.Tensor, rho_opt: torch.Tensor, rho_fix: torch.Tensor
        ) -> torch.Tensor:
    """d fk / d q, (..., 3, 3): row = foot coordinate, column = joint."""
    _, _, lu, s0, c0, s1, c1, fx, fz, _, hy, hz = _terms(q, rho_opt,
                                                         rho_fix)
    zero = torch.zeros_like(s0)
    # d/dq0: roll of (hy, hz) about x
    j0 = (zero, -s0 * hy - c0 * hz, c0 * hy - s0 * hz)
    # d/dq1: d(fx, fz)/dq1 = (fz, -fx); d(-lu s1, -lu c1)/dq1 = (-lu c1, lu s1)
    dhx1 = fz - lu * c1
    dhz1 = -fx + lu * s1
    j1 = (dhx1, -s0 * dhz1, c0 * dhz1)
    # d/dq2: d(fx, fz)/dq2 = (fz, -fx)
    j2 = (fz, s0 * fx, -c0 * fx)
    return torch.stack([torch.stack([j0[r], j1[r], j2[r]], dim=-1)
                        for r in range(3)], dim=-2)


def _per_leg(fn, *args: torch.Tensor) -> torch.Tensor:
    """``fn`` of one leg's (q, rho_opt, rho_fix), ``torch.func.vmap``-ed
    over the arguments' broadcast leading axes."""
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in args))
    flat = [a.expand(lead + a.shape[-1:]).reshape((-1,) + a.shape[-1:])
            for a in args]
    out = torch.func.vmap(fn)(*flat)
    return out.reshape(lead + out.shape[1:])


def _jac_flat(q, rho_opt, rho_fix):
    return jac(q, rho_opt, rho_fix).reshape(9)


def dfk_drho(q: torch.Tensor, rho_opt: torch.Tensor, rho_fix: torch.Tensor
             ) -> torch.Tensor:
    """d fk / d rho_opt, (..., 3, 3) (A1Kinematics::dfk_drho)."""
    return _per_leg(torch.func.jacfwd(fk, argnums=1), q, rho_opt, rho_fix)


def dJ_dq(q: torch.Tensor, rho_opt: torch.Tensor, rho_fix: torch.Tensor
          ) -> torch.Tensor:
    """(..., 9, 3): d J[i, j] / d q_k in row i * 3 + j, column k
    (A1Kinematics::dJ_dq)."""
    return _per_leg(torch.func.jacfwd(_jac_flat, argnums=0), q, rho_opt,
                    rho_fix)


def dJ_drho(q: torch.Tensor, rho_opt: torch.Tensor, rho_fix: torch.Tensor
            ) -> torch.Tensor:
    """(..., 9, 3): d J[i, j] / d rho_opt_k in row i * 3 + j, column k
    (A1Kinematics::dJ_drho)."""
    return _per_leg(torch.func.jacfwd(_jac_flat, argnums=1), q, rho_opt,
                    rho_fix)


def foot_fanout(joint_pos: torch.Tensor, joint_vel: torch.Tensor,
                rho_opt: torch.Tensor, rho_fix: torch.Tensor):
    """Foot positions (..., 4, 3), per-leg Jacobians (..., 4, 3, 3) and
    foot velocities J q_dot (..., 4, 3), body frame, from (..., 12)."""
    q = joint_pos.reshape(joint_pos.shape[:-1] + (4, 3))
    qd = joint_vel.reshape(joint_vel.shape[:-1] + (4, 3))
    pos = fk(q, rho_opt, rho_fix)
    jacs = jac(q, rho_opt, rho_fix)
    vel = torch.einsum("...lij,...lj->...li", jacs, qd)
    return pos, jacs, vel


def ik(p_target: torch.Tensor, rho_opt: torch.Tensor, rho_fix: torch.Tensor,
       q0: torch.Tensor | None = None, iters: int = 12) -> torch.Tensor:
    """Damped-Newton IK: foot targets (..., 3) -> joint angles (..., 3)."""
    if q0 is None:
        q0 = const((0.0, 0.75, -1.5), p_target.dtype,
                   p_target.device).expand(p_target.shape)
    eye = torch.eye(3, dtype=p_target.dtype, device=p_target.device)
    q = q0
    for _ in range(iters):
        err = p_target - fk(q, rho_opt, rho_fix)
        j = jac(q, rho_opt, rho_fix)
        jt = j.transpose(-1, -2)
        jtj = jt @ j + 1e-6 * eye
        q = q + mathx.solve3(jtj, (jt @ err[..., None])[..., 0])
    return q
