"""OSQP-semantics ADMM pieces of the MPC solve (counterpart of the
matching subset of ``ops/qp.py``): settings, solution and scaling types,
modified Ruiz equilibration, per-instance cost rescaling, the
per-constraint stepsize vector, the scaled KKT assembly (dense, shared
basis and block-diagonal), the contact-pattern-reduced KKT inverse, the
host side of the two fused ADMM kernels, and the plain-PyTorch solves
``admm_solve`` (adaptive) and ``admm_solve_fixed`` that the JAX package
runs under ``vmap``.

Solves  minimize 1/2 x'Px + q'x  s.t.  l <= Ax <= u, every operand
batched over scenarios: with A = A0 + mu A1 (the friction-cone
structure, never materialized) on the shared-basis solve, with a
materialized per-scenario A on the legacy one.
"""

from __future__ import annotations

import dataclasses

import torch

from a1_qp_mpc_controller_tpu_torch.ops.kernels import (
    batched_inverse, batched_inverse_small, fused_admm, fused_admm_plain,
    fused_admm_shared,
)
from a1_qp_mpc_controller_tpu_torch.ops.linalg import gj_inverse_unrolled
from a1_qp_mpc_controller_tpu_torch.tensors import (
    host_bool, host_flag_and_indices, tensorclass, top_k_indices, where_b,
)
from a1_qp_mpc_controller_tpu_torch.utils import mathx

MIN_SCALING = 1e-4
MAX_SCALING = 1e4
RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_SCALE = 1e3
RHO_TOL = 1e-4
ADAPTIVE_RHO_TOL = 5.0  # only change rho when it moves by >= 5x (OSQP)


@dataclasses.dataclass(frozen=True)
class QPSettings:
    """Static solver settings (the fields the batched route reads)."""

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    max_iter: int = 4000
    check_every: int = 25
    scaling_iters: int = 10
    adaptive_rho: bool = True
    rho_eq_scale: float = RHO_EQ_SCALE


@tensorclass
class QPSolution:
    x: torch.Tensor          # (B,n) primal
    y: torch.Tensor          # (B,m) dual
    z: torch.Tensor          # (B,m) constraint activity Ax
    iters: torch.Tensor      # (B,) int32
    prim_res: torch.Tensor   # (B,) unscaled ||Ax - z||_inf
    dual_res: torch.Tensor   # (B,) unscaled ||Px + q + A'y||_inf
    converged: torch.Tensor  # (B,) bool
    rho: torch.Tensor        # (B,) post-solve rho estimate


@tensorclass
class Scaling:
    """Precomputed equilibration: variable scaling d, constraint scaling
    e, cost scaling c (leading batch axes on each)."""

    d: torch.Tensor
    e: torch.Tensor
    c: torch.Tensor


@tensorclass
class ScaledProblem:
    """A problem after equilibration, with the scaling that made it."""

    P: torch.Tensor     # (B,n,n)
    q: torch.Tensor     # (B,n)
    A: torch.Tensor     # (B,m,n)
    l: torch.Tensor     # (B,m)
    u: torch.Tensor     # (B,m)
    d: torch.Tensor     # (B,n)
    e: torch.Tensor     # (B,m)
    c: torch.Tensor     # (B,)


def apply_scaling(P, q, A, l, u, s: Scaling) -> ScaledProblem:
    """Apply a precomputed (d, e, c) in one pass."""
    d, e, c = s.d, s.e, s.c
    return ScaledProblem(
        P=(c[:, None, None] * P) * (d[:, :, None] * d[:, None, :]),
        q=c[:, None] * d * q,
        A=A * (e[:, :, None] * d[:, None, :]),
        l=e * l, u=e * u, d=d, e=e, c=c)


def _limit(v: torch.Tensor) -> torch.Tensor:
    v = torch.where(v < MIN_SCALING, torch.ones_like(v), v)
    return torch.clamp(v, MIN_SCALING, MAX_SCALING)


def _inf_norm_cols(m: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(m), dim=-2)


def ruiz_equilibrate(P, q, A, l, u, iters: int = 10):
    """Modified Ruiz equilibration (OSQP section 5.1), batched over
    leading axes. Returns (Ps, qs, As, ls, us, Scaling)."""
    d_acc = torch.ones_like(q)
    e_acc = torch.ones_like(l)
    c_acc = torch.ones_like(q[..., 0])
    for _ in range(iters):
        col = torch.maximum(_inf_norm_cols(P), _inf_norm_cols(A))
        d = 1.0 / torch.sqrt(_limit(col))
        e = 1.0 / torch.sqrt(_limit(torch.amax(torch.abs(A), dim=-1)))
        P = d[..., :, None] * P * d[..., None, :]
        q = d * q
        A = e[..., :, None] * A * d[..., None, :]
        d_acc = d_acc * d
        e_acc = e_acc * e
        col_p = torch.mean(_inf_norm_cols(P), dim=-1)
        norm_q = torch.amax(torch.abs(q), dim=-1)
        gamma = 1.0 / _limit(torch.maximum(col_p, norm_q))
        P = gamma[..., None, None] * P
        q = gamma[..., None] * q
        c_acc = c_acc * gamma
    return P, q, A, e_acc * l, e_acc * u, Scaling(d=d_acc, e=e_acc, c=c_acc)


def compute_scaling(P, q, A, l, u, iters: int = 10) -> Scaling:
    return ruiz_equilibrate(P, q, A, l, u, iters)[-1]


def rescale_cost(P: torch.Tensor, q: torch.Tensor, s: Scaling) -> Scaling:
    """Recompute the cost normalization c for this instance, keeping the
    precomputed d/e (Ruiz's final gamma at the accumulated d)."""
    col_p = torch.mean(
        torch.amax(torch.abs(P) * s.d[..., :, None], dim=-2) * s.d, dim=-1)
    norm_q = torch.amax(torch.abs(s.d * q), dim=-1)
    return s.replace(c=1.0 / _limit(torch.maximum(col_p, norm_q)))


def _rho_vec(l: torch.Tensor, u: torch.Tensor, rho: torch.Tensor,
             eq_scale: float = RHO_EQ_SCALE) -> torch.Tensor:
    """Per-constraint rho, (B, m) from per-scenario ``rho`` (B,):
    equalities stiffened ``eq_scale`` x, free rows at RHO_MIN."""
    eq = (u - l) < RHO_TOL
    loose = torch.isinf(-l) & torch.isinf(u)
    rv = rho[:, None].expand_as(l)
    rv = torch.where(eq, eq_scale * rv, rv)
    rv = torch.where(loose, torch.full_like(rv, RHO_MIN), rv)
    return torch.clamp(rv, RHO_MIN, RHO_MAX)


def _kkt_matrix(P: torch.Tensor, A: torch.Tensor, rho_vec: torch.Tensor,
                sigma: float) -> torch.Tensor:
    """P + sigma I + A' diag(rho) A, batched."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    return P + sigma * eye + (A.transpose(-1, -2) * rho_vec[:, None, :]) @ A


def _kkt_inverse(P: torch.Tensor, A: torch.Tensor, rho_vec: torch.Tensor,
                 sigma: float) -> torch.Tensor:
    """inv(P + sigma I + A' diag(rho) A), batched: the unrolled
    pivot-free Gauss-Jordan for n <= 16 (the stand QP), else
    ``torch.linalg.inv``, as the JAX package (XLA-level code there, not
    a kernel)."""
    m_mat = _kkt_matrix(P, A, rho_vec, sigma)
    if P.shape[-1] <= 16:
        return gj_inverse_unrolled(m_mat)
    return torch.linalg.inv(m_mat)


def scaled_kkt_matrix(P, q, A, l, u, settings: QPSettings,
                      rho0: torch.Tensor, scaling: Scaling) -> torch.Tensor:
    """The scaled KKT matrix the solve factorizes, for callers that
    invert it outside the solve and pass the inverse back as
    ``kkt_inv`` (same settings, rho0 and scaling)."""
    sp = apply_scaling(P, q, A, l, u, scaling)
    rho_vec = _rho_vec(sp.l, sp.u, rho0, settings.rho_eq_scale)
    return _kkt_matrix(sp.P, sp.A, rho_vec, settings.sigma)


def scaled_kkt_matrix_shared(P: torch.Tensor, a0: torch.Tensor,
                             a1: torch.Tensor, mu: torch.Tensor,
                             l: torch.Tensor, u: torch.Tensor,
                             settings: QPSettings, rho0: torch.Tensor,
                             scaling: Scaling) -> torch.Tensor:
    """Scaled KKT matrix for A_s = A0 + mu_s A1 as one batched product:
    Ps + sigma I + G' diag(rho e^2) G with G = (A0 + mu A1) diag(d)."""
    d, e, c = scaling.d, scaling.e, scaling.c
    n = P.shape[-1]
    Ps = (c[:, None, None] * P) * (d[:, :, None] * d[:, None, :])
    rho_vec = _rho_vec(e * l, e * u, rho0, settings.rho_eq_scale)
    g = (a0[None] + mu[:, None, None] * a1[None]) * d[:, None, :]
    gw = g * (rho_vec * e * e)[:, :, None]
    return (Ps + settings.sigma * torch.eye(n, dtype=P.dtype,
                                            device=P.device)
            + torch.einsum("bmi,bmj->bij", g, gw))


def live_first(live: torch.Tensor, k: int) -> torch.Tensor:
    """(B, k) indices of the first ``k`` entries of a live-first stable
    permutation of each row of the (B, N) mask ``live``."""
    order = torch.argsort(torch.where(live, 0, 1), dim=1, stable=True)
    return order[:, :k]


def gather_square(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """m[b][idx[b]][:, idx[b]] for each b: (B, N, N) -> (B, k, k)."""
    rows = torch.arange(m.shape[0], device=m.device)[:, None, None]
    return m[rows, idx[:, :, None], idx[:, None, :]]


def reduced_kkt_inverse(m_b: torch.Tensor, live: torch.Tensor,
                        n_r: int = 64, big_capacity: int = 256
                        ) -> torch.Tensor:
    """Inverse of the swing-eliminated KKT family by contact-pattern
    shape reduction: live and dead variables do not couple, and the
    dead part is 3x3 block-diagonal, so K^-1 is the scattered inverse of
    the gathered live block (K3 at n_r x n_r) plus closed-form inverses
    of the dead 3x3 blocks. Scenarios with more than ``n_r`` live
    variables are inverted at full size (K1) in a ``big_capacity``
    bucket; when more than ``big_capacity`` of them exist, the whole
    batch is (one host read, the ``lax.cond`` of the JAX package).

    ``live``: (B, n) bool stance-variable mask; n % 3 == 0."""
    b, n, _ = m_b.shape
    assert n % 3 == 0
    dtype = m_b.dtype
    if big_capacity >= b or n_r >= n:
        return batched_inverse(m_b)
    n_live = torch.sum(live, dim=1)
    if host_bool(torch.sum(n_live > n_r) > big_capacity):
        return batched_inverse(m_b)
    # for n_live < n_r the tail of the gather picks up dead entries,
    # whose junk inverse is masked out below
    idx = live_first(live, n_r)
    rows = torch.arange(b, device=m_b.device)[:, None, None]
    l_inv = batched_inverse_small(gather_square(m_b, idx))
    out = torch.zeros_like(m_b)
    out[rows, idx[:, :, None], idx[:, None, :]] = l_inv
    lm = live.to(dtype)
    out = out * (lm[:, :, None] * lm[:, None, :])
    # dead 3x3 diagonal blocks, closed-form inverse, placed back
    nblk = n // 3
    diag_blocks = torch.diagonal(m_b.reshape(b, nblk, 3, nblk, 3),
                                 dim1=1, dim2=3).permute(0, 3, 1, 2)
    dead_blk = (~live[:, ::3]).to(dtype)
    dinv = mathx.inv3_spd(diag_blocks) * dead_blk[:, :, None, None]
    eye_t = torch.eye(nblk, dtype=dtype, device=m_b.device)
    out = out + (dinv[:, :, :, None, :]
                 * eye_t[None, :, None, :, None]).reshape(b, n, n)
    # full-size bucket: the big_capacity scenarios with the most live
    # variables (every n_live > n_r scenario, the overflow aside)
    big_idx = top_k_indices(n_live, big_capacity)
    out[big_idx] = batched_inverse(m_b[big_idx])
    return out


def scaled_kkt_matrix_blockdiag(P: torch.Tensor, base_blk: torch.Tensor,
                                slope_blk: torch.Tensor, mu: torch.Tensor,
                                l: torch.Tensor, u: torch.Tensor,
                                settings: QPSettings, rho0: torch.Tensor,
                                scaling: Scaling) -> torch.Tensor:
    """Scaled KKT matrix Ps + sigma I + G' diag(rho e^2) G, G = A diag(d),
    using that A is block-diagonal with (5,3) blocks base + mu * slope:
    A'WA is one 3x3 block per (step, leg) on the diagonal."""
    d, e, c = scaling.d, scaling.e, scaling.c
    b, n = P.shape[0], P.shape[-1]
    nblk = n // 3
    Ps = (c[:, None, None] * P) * (d[:, :, None] * d[:, None, :])
    rho_vec = _rho_vec(e * l, e * u, rho0, settings.rho_eq_scale)
    w = (rho_vec * e * e).reshape(b, nblk, 5)
    blk = base_blk + mu[:, None, None] * slope_blk               # (B,5,3)
    wblk = w[:, :, :, None] * blk[:, None, :, :]                 # (B,T,5,3)
    blocks = torch.einsum("brc,btrq->btcq", blk, wblk)           # (B,T,3,3)
    d3 = d.reshape(b, nblk, 3)
    blocks = blocks * d3[:, :, :, None] * d3[:, :, None, :]
    eye_t = torch.eye(nblk, dtype=P.dtype, device=P.device)
    bd = (blocks[:, :, :, None, :]
          * eye_t[None, :, None, :, None]).reshape(b, n, n)
    eye_n = torch.eye(n, dtype=P.dtype, device=P.device)
    return Ps + settings.sigma * eye_n + bd


def shared_admm_operands(q: torch.Tensor, a0: torch.Tensor,
                         a1: torch.Tensor, mu: torch.Tensor, l: torch.Tensor,
                         u: torch.Tensor, settings: QPSettings,
                         x0: torch.Tensor, y0: torch.Tensor,
                         rho0: torch.Tensor, scaling: Scaling,
                         kkt_inv: torch.Tensor) -> dict:
    """The fused ADMM kernel's operands in the scaled space: scaled cost
    and bounds, per-constraint rho and the scaled warm start, keyed by
    the kernel's argument names."""
    d, e, c = scaling.d, scaling.e, scaling.c
    ls, us = e * l, e * u
    return dict(
        a0=a0, a1=a1, minv=kkt_inv, mu=mu, d=d, e=e, qs=c[:, None] * d * q,
        ls=ls, us=us, rho_vec=_rho_vec(ls, us, rho0, settings.rho_eq_scale),
        x0=x0 / d, y0=c[:, None] * y0 / e,
        z0=torch.clamp(e * _amul(a0, a1, mu, x0), ls, us))


def _amul(a0, a1, mu, x):      # (B,n) -> (B,m): (A0 + mu A1) x
    return x @ a0.T + mu[:, None] * (x @ a1.T)


def _atmul(a0, a1, mu, w):     # (B,m) -> (B,n): (A0 + mu A1)' w
    return w @ a0 + (mu[:, None] * w) @ a1


def _inf(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(v), dim=1)


def _bmv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bmn,bn->bm", a, x)      # (B,m,n) x (B,n)


def _bmtv(a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bmn,bm->bn", a, y)      # (B,m,n)' x (B,m)


def _exit_test(P, q, ax, aty, xu, zu, s: QPSettings):
    """Unscaled residuals and OSQP's exit test at an unscaled iterate,
    from its products ``ax`` = A xu and ``aty`` = A' yu: (B,) prim_res,
    dual_res and converged."""
    px = torch.einsum("bij,bj->bi", P, xu)
    rp = _inf(ax - zu)
    rd = _inf(px + q + aty)
    eps_prim = s.eps_abs + s.eps_rel * torch.maximum(_inf(ax), _inf(zu))
    eps_dual = s.eps_abs + s.eps_rel * torch.maximum(
        torch.maximum(_inf(px), _inf(aty)), _inf(q))
    return rp, rd, (rp <= eps_prim) & (rd <= eps_dual)


def _rho_estimate(Ps, qs, As, x, y, z, rho):
    """OSQP's compute_rho_estimate on scaled iterates (no 5x threshold),
    batched: (B,) from per-scenario ``rho``."""
    return _rho_from_products(_bmv(As, x), torch.einsum("bij,bj->bi", Ps, x),
                              _bmtv(As, y), z, qs, rho)


def _rho_from_products(ax, px, aty, z, qs, rho):
    """:func:`_rho_estimate` from the scaled products A x, P x, A' y."""
    div_tol = 1e-12
    rp_rel = _inf(ax - z) / torch.clamp(
        torch.maximum(_inf(ax), _inf(z)), min=div_tol)
    rd_rel = _inf(px + qs + aty) / torch.clamp(torch.maximum(
        torch.maximum(_inf(px), _inf(aty)), _inf(qs)), min=div_tol)
    return torch.clamp(
        rho * torch.sqrt(rp_rel / torch.clamp(rd_rel, min=div_tol)),
        RHO_MIN, RHO_MAX)


def legacy_admm_operands(sp: ScaledProblem, settings: QPSettings,
                         x0: torch.Tensor, y0: torch.Tensor,
                         rho0: torch.Tensor, kkt_inv: torch.Tensor) -> dict:
    """The fused ADMM kernel's (K4's) operands for a scaled problem: the
    scaled warm start and per-constraint rho, keyed by the kernel's
    argument names."""
    xs = x0 / sp.d
    return dict(
        minv=kkt_inv, a_s=sp.A, qs=sp.q, ls=sp.l, us=sp.u,
        rho_vec=_rho_vec(sp.l, sp.u, rho0, settings.rho_eq_scale),
        x0=xs, y0=sp.c[:, None] * y0 / sp.e,
        z0=torch.clamp(torch.einsum("bmn,bn->bm", sp.A, xs), sp.l, sp.u))


def admm_solve_fixed_batched(P: torch.Tensor, q: torch.Tensor,
                             A: torch.Tensor, l: torch.Tensor,
                             u: torch.Tensor, iters: int,
                             settings: QPSettings, x0: torch.Tensor,
                             y0: torch.Tensor, rho0: torch.Tensor,
                             scaling: Scaling,
                             kkt_inv: torch.Tensor) -> QPSolution:
    """Batched fixed-iteration solve with a materialized per-scenario A
    through the fused ADMM kernel (ops/kernels.fused_admm): scaling and
    warm start, the kernel, then unscale, unscaled residuals,
    convergence and the rho estimate. ``kkt_inv`` inverts
    :func:`scaled_kkt_matrix` at the same settings, rho0 and scaling."""
    s = settings
    sp = apply_scaling(P, q, A, l, u, scaling)
    x, y, z = fused_admm(**legacy_admm_operands(sp, s, x0, y0, rho0,
                                                kkt_inv),
                         iters=iters, sigma=s.sigma, alpha=s.alpha)

    xu = sp.d * x
    yu = y * sp.e / sp.c[:, None]
    zu = z / sp.e
    rp, rd, conv = _exit_test(P, q, _bmv(A, xu), _bmtv(A, yu), xu, zu, s)
    return QPSolution(
        x=xu, y=yu, z=zu,
        iters=torch.full((P.shape[0],), iters, dtype=torch.int32,
                         device=P.device),
        prim_res=rp, dual_res=rd, converged=conv,
        rho=_rho_estimate(sp.P, sp.q, sp.A, x, y, z, rho0))


def admm_solve_fixed_batched_shared(
        P: torch.Tensor, q: torch.Tensor, a0: torch.Tensor, a1: torch.Tensor,
        mu: torch.Tensor, l: torch.Tensor, u: torch.Tensor, iters: int,
        settings: QPSettings, x0: torch.Tensor, y0: torch.Tensor,
        rho0: torch.Tensor, scaling: Scaling,
        kkt_inv: torch.Tensor) -> QPSolution:
    """Batched fixed-iteration solve for A_s = A0 + mu_s A1 through the
    fused ADMM kernel (ops/kernels.fused_admm_shared): scaling, warm
    start, the kernel, then unscale, unscaled residuals, convergence and
    the rho estimate on the host side of the kernel."""
    s = settings
    d, e, c = scaling.d, scaling.e, scaling.c
    Ps = (c[:, None, None] * P) * (d[:, :, None] * d[:, None, :])
    ops = shared_admm_operands(q, a0, a1, mu, l, u, s, x0, y0, rho0,
                               scaling, kkt_inv)
    qs = ops["qs"]
    amul = lambda x: _amul(a0, a1, mu, x)
    atmul = lambda w: _atmul(a0, a1, mu, w)

    x, y, z = fused_admm_shared(**ops, iters=iters, sigma=s.sigma,
                                alpha=s.alpha)

    xu = d * x
    yu = y * e / c[:, None]
    zu = z / e
    rp, rd, conv = _exit_test(P, q, amul(xu), atmul(yu), xu, zu, s)
    rho_est = _rho_from_products(
        e * amul(d * x), torch.einsum("bij,bj->bi", Ps, x),
        d * atmul(e * y), z, qs, rho0)

    return QPSolution(
        x=xu, y=yu, z=zu,
        iters=torch.full((P.shape[0],), iters, dtype=torch.int32,
                         device=P.device),
        prim_res=rp, dual_res=rd, converged=conv, rho=rho_est)


def admm_solve(P: torch.Tensor, q: torch.Tensor, A: torch.Tensor,
               l: torch.Tensor, u: torch.Tensor,
               settings: QPSettings = QPSettings(),
               x0: torch.Tensor | None = None,
               y0: torch.Tensor | None = None,
               rho0: torch.Tensor | None = None,
               scaling: Scaling | None = None,
               kkt_inv: torch.Tensor | None = None) -> QPSolution:
    """The adaptive ADMM solve over a batch, each scenario as the JAX
    package's ``admm_solve`` does it under ``vmap``: blocks of
    ``check_every`` iterations, after each the unscaled residual test
    and (``adaptive_rho``) OSQP's rho estimate with a refactor where it
    moves 5x, until the scenario converges or reaches ``max_iter``. A
    scenario that has stopped keeps its state while the others run on;
    the batch stops when every scenario has. The exit test is read on
    the host after each block but the last, in the same copy as the
    indices of the scenarios whose rho moved (one read a block,
    ``tensors.host_syncs``), and a refactor inverts only those.
    ``x0``/``y0``/``rho0`` warm-start, ``scaling`` replaces the Ruiz
    sweep, ``kkt_inv`` (needs ``adaptive_rho=False``) replaces the
    factorization."""
    s = settings
    b, n = q.shape
    m = l.shape[1]
    if scaling is None:
        Ps, qs, As, ls, us, scaling = ruiz_equilibrate(P, q, A, l, u,
                                                       s.scaling_iters)
    else:
        sp = apply_scaling(P, q, A, l, u, scaling)
        Ps, qs, As, ls, us = sp.P, sp.q, sp.A, sp.l, sp.u
    d, e, c = scaling.d, scaling.e, scaling.c
    x = q.new_zeros((b, n)) if x0 is None else x0 / d
    y = q.new_zeros((b, m)) if y0 is None else c[:, None] * y0 / e
    z = torch.clamp(_bmv(As, x), ls, us)
    rho = q.new_full((b,), s.rho) if rho0 is None else rho0
    rho_vec = _rho_vec(ls, us, rho, s.rho_eq_scale)
    if kkt_inv is None:
        minv = _kkt_inverse(Ps, As, rho_vec, s.sigma)
    elif s.adaptive_rho:
        raise ValueError("kkt_inv requires adaptive_rho=False (a rho "
                         "change would refactorize)")
    else:
        minv = kkt_inv

    def residuals(x, y, z):
        xu, yu, zu = d * x, y * e / c[:, None], z / e
        return _exit_test(P, q, _bmv(A, xu), _bmtv(A, yu), xu, zu, s)

    it = torch.zeros((b,), dtype=torch.int32, device=q.device)
    done = torch.zeros((b,), dtype=torch.bool, device=q.device)
    rp = rd = q.new_full((b,), float("inf"))
    n_blocks = -(-s.max_iter // s.check_every)
    for blk in range(n_blocks):
        # every scenario that has not converged has run blk blocks, fewer
        # than max_iter iterations: the first block runs them all
        active = ~done
        x1, y1, z1 = fused_admm_plain(minv, As, qs, ls, us, rho_vec, x, y, z,
                                      iters=s.check_every, sigma=s.sigma,
                                      alpha=s.alpha, reciprocal=False)
        rp1, rd1, done1 = residuals(x1, y1, z1)
        if s.adaptive_rho:
            rho_new = _rho_estimate(Ps, qs, As, x1, y1, z1, rho)
            change = ((rho_new > ADAPTIVE_RHO_TOL * rho)
                      | (rho_new < rho / ADAPTIVE_RHO_TOL))
            update = change & ~done1 & active
            rho = torch.where(update, rho_new, rho)
            rho_vec = where_b(update, _rho_vec(ls, us, rho, s.rho_eq_scale),
                              rho_vec)
        x, y, z = (where_b(active, new, old)
                   for new, old in ((x1, x), (y1, y), (z1, z)))
        it = torch.where(active, it + s.check_every, it)
        rp = torch.where(active, rp1, rp)
        rd = torch.where(active, rd1, rd)
        done = torch.where(active, done1, done)
        if blk + 1 == n_blocks:         # the last block's inverse is unused
            break
        if s.adaptive_rho:  # one read: the exit test and whom to refactor
            more, idx = host_flag_and_indices(torch.any(~done), update)
            if more and idx.numel():    # minv is this solve's own here
                minv[idx] = _kkt_inverse(Ps[idx], As[idx], rho_vec[idx],
                                         s.sigma)
        else:
            more = host_bool(torch.any(~done))
        if not more:
            break

    return QPSolution(
        x=d * x, y=y * e / c[:, None], z=z / e, iters=it, prim_res=rp,
        dual_res=rd, converged=done,
        rho=_rho_estimate(Ps, qs, As, x, y, z, rho))


def admm_solve_fixed(P: torch.Tensor, q: torch.Tensor, A: torch.Tensor,
                     l: torch.Tensor, u: torch.Tensor, iters: int,
                     settings: QPSettings = QPSettings(),
                     x0: torch.Tensor | None = None,
                     y0: torch.Tensor | None = None,
                     rho0: torch.Tensor | None = None,
                     scaling: Scaling | None = None,
                     kkt_inv: torch.Tensor | None = None) -> QPSolution:
    """Fixed-iteration variant: :func:`admm_solve` with ``max_iter =
    check_every = iters`` and no adaptation, so every scenario runs
    ``iters`` iterations and the host reads nothing. The returned ``rho``
    is the post-solve estimate."""
    s = dataclasses.replace(settings, max_iter=iters, check_every=iters,
                            adaptive_rho=False)
    return admm_solve(P, q, A, l, u, s, x0, y0, rho0, scaling, kkt_inv)
