"""Kinematic calibration (counterpart of ``models/calibration.py``):
estimate one leg's contact offset rho_opt from observed data, the use the
reference generates its ``dfk_drho`` / ``dJ_drho`` matrices for
(A1Kinematics.h:16-19).

- :func:`calibrate_foot_positions`: Gauss-Newton on FK residuals against
  observed foot positions, ``iters`` fixed, with the ``dfk_drho``
  Jacobian.
- :func:`calibrate_leg_odometry`: the self-supervised variant. In stance
  the world-frame foot velocity is zero, so J(q, rho) q_dot must explain
  the measured relative foot velocity; linearized at rho = 0 through
  ``dJ_drho`` that is a least-squares problem linear in rho.

Every product runs in exact float32 (the package forbids TF32; the JAX
package asks for ``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.models import kinematics as kin


def calibrate_foot_positions(q_samples: torch.Tensor,
                             p_observed: torch.Tensor,
                             rho_fix: torch.Tensor,
                             rho0: torch.Tensor | None = None,
                             iters: int = 10, damping: float = 1e-6
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """rho_opt (3,) minimizing ||fk(q_t, rho) - p_obs_t||^2 over the T
    samples: q_samples (T, 3) joint angles, p_observed (T, 3) measured
    foot positions (hip frame), rho_fix (5,). Returns (rho_opt (3,),
    final rms residual ())."""
    rho = q_samples.new_zeros(3) if rho0 is None else rho0
    eye = torch.eye(3, dtype=rho.dtype, device=rho.device)
    for _ in range(iters):
        resid = kin.fk(q_samples, rho, rho_fix) - p_observed       # (T,3)
        jac = kin.dfk_drho(q_samples, rho, rho_fix)                 # (T,3,3)
        jtj = torch.einsum("tij,tik->jk", jac, jac)
        jtr = torch.einsum("tij,ti->j", jac, resid)
        rho = rho - torch.linalg.solve(jtj + damping * eye, jtr)
    resid = kin.fk(q_samples, rho, rho_fix) - p_observed
    return rho, torch.sqrt(torch.mean(resid ** 2))


def calibrate_leg_odometry(q_samples: torch.Tensor, qd_samples: torch.Tensor,
                           body_vel_rel: torch.Tensor, rho_fix: torch.Tensor,
                           damping: float = 1e-8) -> torch.Tensor:
    """Self-supervised rho_opt (3,) from stance-phase proprioception:
    q_samples, qd_samples (T, 3), body_vel_rel (T, 3) the relative foot
    velocity b_t the kinematics must explain. With A_t[i, k] =
    sum_j dJ[i, j] / d rho_k qd[j] at rho = 0, solves the least squares
    A_t rho = b_t - J0_t q_dot."""
    zero = q_samples.new_zeros(3)
    j0 = kin.jac(q_samples, zero, rho_fix)                          # (T,3,3)
    djdr = kin.dJ_drho(q_samples, zero, rho_fix)                    # (T,9,3)
    a_t = torch.einsum("tijk,tj->tik",
                       djdr.reshape(djdr.shape[0], 3, 3, 3), qd_samples)
    resid = body_vel_rel - torch.einsum("tij,tj->ti", j0, qd_samples)
    ata = torch.einsum("tik,til->kl", a_t, a_t)
    atb = torch.einsum("tik,ti->k", a_t, resid)
    eye = torch.eye(3, dtype=ata.dtype, device=ata.device)
    return torch.linalg.solve(ata + damping * eye, atb)
