"""Batched closed-loop MPC tick (counterpart of the batched subset of
``parallel/batched.py``): batched build, the hoisted solve through the
Gauss-Jordan and fused-ADMM kernels (ops/kernels.py), batched finish and
the plant step.

Routes, as ``batched_control_tick`` selects them:

- ``admm_backend='pallas_shared'`` (the shared-basis fused ADMM, K2; the
  names are the JAX package's) with ``kkt_backend``
  - 'gj': per-tick refactor (K1) and an inline flip-rescue pass;
  - 'reduced': the same, with the inverse by contact-pattern shape
    reduction (``ops/qp.reduced_kkt_inverse``: K3 on the live block, K1
    on the big bucket);
  - 'chol', 'schur', 'sweep_t', 'gj_t': the same, with the inverse by
    the blocked Cholesky (``ops/linalg.spd_cholesky_inverse``, plain
    PyTorch as in the JAX package, no kernel of its own), the
    Schur-complement recursion (``ops/kernels_retired.spd_block_inverse``,
    K3 at its base; documented unsafe on this family), the batch-last
    sweep (K6j) or the batch-last Gauss-Jordan (K6g);
  - 'amortized': cross-tick amortized factorization (K1 on the refreshed
    subset, a Neumann correction for the rest);
  - 'reduced_admm': the whole solve (K3 inverse and K2 ADMM) at the
    gathered stance-block shape, a full-size big bucket, two
    rho-refactored rescue rounds per tier. At ``kkt_reduced_nr`` >= the
    variable count (the bench's 'full' candidate, 128) it is the
    full-size solve with the same rescue and the round-robin polish;
  - any other name raises ``ValueError`` listing ``KKT_BACKENDS`` (the
    JAX package runs 'gj' for it);
- ``admm_backend='pallas'`` (legacy): a materialized per-scenario A, the
  scaled KKT inverted by K1 (``use_pallas``) or ``torch.linalg.inv``,
  the ADMM in K4; no rescue;
- ``admm_backend='xla'``, the default as in the JAX package: the same
  inverse, then ``ops/qp.admm_solve_fixed`` with it, the batched plain
  PyTorch ADMM (the JAX package's vmapped XLA solve); no rescue.

Where the JAX package branches on device with ``lax.cond``, this module
branches in Python on a device scalar (``tensors.host_bool``): each such
branch is one host sync, counted in ``tensors.host_syncs``. Reads per
tick with the rescue pool on and the polish off: 'gj', 'chol', 'schur',
'sweep_t', 'gj_t', 'pallas' and 'xla' 0, 'reduced' 1 (the overflow test),
'amortized' 4, 'reduced_admm' at the full size 1 (the straggler round),
on the reduced tier 3 (overflow, one straggler round per tier) or 2 on a
tick that overflows to the full size.

``batched_stand_control_tick`` is the stand-QP profiles' batched tick:
the 12-variable QPs solved lock-step in plain PyTorch (no kernel, as the
JAX package leaves them to XLA), with a gathered rescue of the worst
unconverged scenarios; its one read a tick is the rescue's branch.
"""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.config import A1Config, RobotParams
from a1_qp_mpc_controller_tpu_torch.control import grf
from a1_qp_mpc_controller_tpu_torch.control.controller import (
    control_tick_build, control_tick_build_qp, control_tick_finish,
    control_tick_finish_qp,
)
from a1_qp_mpc_controller_tpu_torch.models import srb
from a1_qp_mpc_controller_tpu_torch.ops import kernels_retired as retired
from a1_qp_mpc_controller_tpu_torch.ops import linalg
from a1_qp_mpc_controller_tpu_torch.ops import qp as qpx
from a1_qp_mpc_controller_tpu_torch.ops.kernels import (
    batched_inverse, batched_inverse_small,
)
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as cl
from a1_qp_mpc_controller_tpu_torch.sim import plant as plant_mod
from a1_qp_mpc_controller_tpu_torch.sim import terrain as terrain_mod
from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, broadcast_batch, check_on, const, host_bool, resolve_device,
    tensorclass, top_k_indices, tree_map, where_b,
)
from a1_qp_mpc_controller_tpu_torch.types import JoyCmd


def _take(tree, idx: torch.Tensor):
    return tree_map(lambda a: a[idx], tree)


def _merge(sol, sol_r, idx: torch.Tensor, sel: torch.Tensor):
    """Scatter ``sol_r`` into ``sol`` at ``idx`` where ``sel``; the other
    gathered slots keep their value (``orig.at[idx].set(where(...))``)."""
    def one(orig, new):
        out = orig.clone()
        out[idx] = where_b(sel, new, orig[idx])
        return out
    return tree_map(one, sol, sol_r)


def _put(tree, idx: torch.Tensor, new_tree):
    """``orig.at[idx].set(new)`` leafwise."""
    def one(orig, new):
        out = orig.clone()
        out[idx] = new
        return out
    return tree_map(one, tree, new_tree)


def _gathered_rescue(sol, p_of, q_of, l_of, u_of, scal_of, a0, a1, mu_v,
                     small_inverse, settings, *, cap: int,
                     rescue_iters: int, rescue_flag, rho0_base, base_blk,
                     slope_blk, eligible=None,
                     unconverged_only: bool = False):
    """Rank the scenarios that are unconverged (or, unless
    ``unconverged_only``, rescue-flagged) among the ``eligible``, gather
    the worst ``cap``, refactor their KKT (``small_inverse``) at the
    first pass's clamped rho estimate where unconverged (flagged but
    converged ones keep ``rho0_base``), continue ``rescue_iters``
    iterations and scatter back where the rescue was needed and does
    not worsen the residual picture."""
    need = ~sol.converged
    if not unconverged_only:
        need = need | rescue_flag
    if eligible is not None:
        need = need & eligible
    score = need.to(q_of.dtype) * (
        1.0 + torch.maximum(sol.prim_res, sol.dual_res))
    cap = min(cap, score.shape[0])
    ridx = top_k_indices(score, cap)
    scal_r = _take(scal_of, ridx)
    conv_g = sol.converged[ridx]
    rho_est = torch.clamp(sol.rho[ridx], 0.1 * grf._MPC_RHO0,
                          100.0 * grf._MPC_RHO0)
    rho_r = torch.where(conv_g, rho0_base[ridx], rho_est)
    m_r = qpx.scaled_kkt_matrix_blockdiag(
        p_of[ridx], base_blk, slope_blk, mu_v[ridx], l_of[ridx], u_of[ridx],
        settings, rho_r, scal_r)
    sol_r = qpx.admm_solve_fixed_batched_shared(
        p_of[ridx], q_of[ridx], a0, a1, mu_v[ridx], l_of[ridx], u_of[ridx],
        rescue_iters, settings, sol.x[ridx], sol.y[ridx], rho_r, scal_r,
        small_inverse(m_r))
    res_o = torch.maximum(sol.prim_res[ridx], sol.dual_res[ridx])
    res_n = torch.maximum(sol_r.prim_res, sol_r.dual_res)
    sel = need[ridx] & (~conv_g | sol_r.converged | (res_n < res_o))
    return _merge(sol, sol_r, ridx, sel)


def _gathered_polish(sol, p_of, q_of, l_of, u_of, scal_of, a0, a1, mu_v,
                     minv_of, rho_of, settings, *, due, cap: int,
                     iters: int):
    """Gather the ``due`` scenarios (top ``cap`` by residual), continue
    ``iters`` iterations at their carried stepsize and effective inverse
    (no refactor), accept where the residual picture does not worsen.
    Returns (solution, which scenarios got a slot)."""
    score = due.to(q_of.dtype) * (
        1.0 + torch.maximum(sol.prim_res, sol.dual_res))
    cap = min(cap, score.shape[0])
    ridx = top_k_indices(score, cap)
    sol_r = qpx.admm_solve_fixed_batched_shared(
        p_of[ridx], q_of[ridx], a0, a1, mu_v[ridx], l_of[ridx], u_of[ridx],
        iters, settings, sol.x[ridx], sol.y[ridx], rho_of[ridx],
        _take(scal_of, ridx), minv_of[ridx])
    res_o = torch.maximum(sol.prim_res[ridx], sol.dual_res[ridx])
    res_n = torch.maximum(sol_r.prim_res, sol_r.dual_res)
    sel = due[ridx] & (sol_r.converged | (res_n <= res_o))
    taken = torch.zeros_like(due)
    taken[ridx] = due[ridx]
    return _merge(sol, sol_r, ridx, sel), taken


def polish_due_mask(cfg: A1Config, mem_b) -> torch.Tensor | None:
    """(B,) bool: (tick + scenario index) % K == 0, staggering the
    round-robin polish load evenly across a lock-step batch."""
    if cfg.mpc_polish_iters <= 0 or cfg.mpc_polish_every <= 0:
        return None
    b = mem_b.tick.shape[0]
    idx = torch.arange(b, dtype=mem_b.tick.dtype, device=mem_b.tick.device)
    return ((mem_b.tick + idx) % cfg.mpc_polish_every) == 0


@tensorclass
class KktCarry:
    """Cross-tick KKT factorization carry of the amortized route: the
    inverse, the scaled KKT it inverts, and the scaling/rho it was built
    at (frozen with it), plus each scenario's age in ticks."""

    minv: torch.Tensor    # (B,n,n)
    m_mat: torch.Tensor   # (B,n,n)
    d: torch.Tensor       # (B,n)
    e: torch.Tensor       # (B,m)
    c: torch.Tensor       # (B,)
    rho: torch.Tensor     # (B,)
    age: torch.Tensor     # (B,) int32


def make_kkt_carry(cfg: A1Config, batch: int, dtype=torch.float32,
                   device=CUDA) -> KktCarry:
    """Cold carry: huge ages, so the first amortized tick refreshes every
    scenario."""
    device = resolve_device(device)
    n, m = cfg.n_mpc_vars, cfg.n_mpc_constraints
    eye = torch.eye(n, dtype=dtype, device=device).expand(batch, n, n)
    ones = lambda *s: torch.ones((batch,) + s, dtype=dtype, device=device)
    return KktCarry(
        minv=eye.clone(), m_mat=eye.clone(), d=ones(n), e=ones(m), c=ones(),
        rho=torch.full((batch,), grf._MPC_RHO0, dtype=dtype, device=device),
        age=torch.full((batch,), 1_000_000, dtype=torch.int32,
                       device=device))


def _amortized_full_solve(cfg: A1Config, prob, scal_new, mu, settings,
                          kcarry: KktCarry, *, capacity: int,
                          rescue_capacity: int, rescue_iters: int,
                          refine_order: int, polish_due=None):
    """Full-size solve with the KKT factorization amortized across ticks:
    refresh ``capacity`` scenarios (flips first, then oldest; all of them
    when the flips overflow the capacity), solve every scenario with

        minv_eff = (I + C + ... + C^refine_order) minv,
        C = minv (m_mat - K_t)

    (a truncated Neumann series in difference form), then the
    continuation and rho-refactored rescue rounds and the round-robin
    polish."""
    b, n = prob.q_vec.shape
    dtype, dev = prob.q_vec.dtype, prob.q_vec.device
    base_blk, slope_blk = srb.friction_basis_blocks(dtype, dev)
    a0f, a1f = srb.friction_constraint_basis(cfg.horizon, dtype, dev)

    assert capacity > 0
    capacity = min(capacity, b)
    stale_max = max(16, 4 * b // capacity)
    must = prob.flipped | (kcarry.age >= stale_max)
    if host_bool(torch.sum(must.to(torch.int32)) > capacity):
        m_b = qpx.scaled_kkt_matrix_blockdiag(
            prob.p_mat, base_blk, slope_blk, mu, prob.lb, prob.ub,
            settings, prob.rho0, scal_new)
        kcarry = KktCarry(minv=batched_inverse(m_b), m_mat=m_b,
                          d=scal_new.d, e=scal_new.e, c=scal_new.c,
                          rho=prob.rho0,
                          age=torch.zeros((b,), dtype=torch.int32,
                                          device=dev))
    else:
        score = kcarry.age.to(dtype) + torch.where(must, 1e9, 0.0)
        ridx = top_k_indices(score, capacity)
        scal_g = _take(scal_new, ridx)
        m_g = qpx.scaled_kkt_matrix_blockdiag(
            prob.p_mat[ridx], base_blk, slope_blk, mu[ridx], prob.lb[ridx],
            prob.ub[ridx], settings, prob.rho0[ridx], scal_g)
        minv_g = batched_inverse(m_g)

        kcarry = _put(kcarry.replace(age=kcarry.age + 1), ridx, KktCarry(
            minv=minv_g, m_mat=m_g, d=scal_g.d, e=scal_g.e, c=scal_g.c,
            rho=prob.rho0[ridx],
            age=torch.zeros_like(ridx, dtype=torch.int32)))
    scal_used = qpx.Scaling(d=kcarry.d, e=kcarry.e, c=kcarry.c)
    rho_used = kcarry.rho

    # current-tick KKT at the frozen (scaling, rho): zero correction for
    # just-refreshed scenarios
    k_cur = qpx.scaled_kkt_matrix_blockdiag(
        prob.p_mat, base_blk, slope_blk, mu, prob.lb, prob.ub, settings,
        rho_used, scal_used)
    c_mat = kcarry.minv @ (kcarry.m_mat - k_cur)
    minv_eff = kcarry.minv
    corr = kcarry.minv
    for _ in range(refine_order):
        corr = c_mat @ corr
        minv_eff = minv_eff + corr

    sol = qpx.admm_solve_fixed_batched_shared(
        prob.p_mat, prob.q_vec, a0f, a1f, mu, prob.lb, prob.ub,
        cfg.mpc_qp_iters, settings, prob.warm_x, prob.warm_y, rho_used,
        scal_used, minv_eff)

    if rescue_capacity > 0:
        def cont(s, due):
            return _gathered_polish(
                s, prob.p_mat, prob.q_vec, prob.lb, prob.ub, scal_used,
                a0f, a1f, mu, minv_eff, rho_used, settings, due=due,
                cap=rescue_capacity, iters=rescue_iters)

        # (a) accuracy continuation of flagged-but-converged scenarios,
        # plus one overflow round when the due count exceeds the pool
        due_acc = prob.rescue_flag & sol.converged
        sol, taken = cont(sol, due_acc)
        due_left = due_acc & ~taken
        if host_bool(torch.any(due_left)):
            sol, _ = cont(sol, due_left)

        # (b) rho-refactored rescue of unconverged scenarios, skipped on
        # all-converged ticks, then a smaller straggler round
        for cap in (max(16, rescue_capacity // 2),
                    max(8, rescue_capacity // 4)):
            if not host_bool(torch.all(sol.converged)):
                sol = _gathered_rescue(
                    sol, prob.p_mat, prob.q_vec, prob.lb, prob.ub,
                    scal_used, a0f, a1f, mu, batched_inverse, settings,
                    cap=cap, rescue_iters=rescue_iters,
                    rescue_flag=prob.rescue_flag, rho0_base=rho_used,
                    base_blk=base_blk, slope_blk=slope_blk,
                    unconverged_only=True)
    if polish_due is not None:
        due = polish_due & ~prob.rescue_flag
        cap_p = max(1, -(-b // cfg.mpc_polish_every))
        sol, _ = _gathered_polish(
            sol, prob.p_mat, prob.q_vec, prob.lb, prob.ub, scal_used,
            a0f, a1f, mu, minv_eff, rho_used, settings, due=due, cap=cap_p,
            iters=cfg.mpc_polish_iters)
    return sol, kcarry


def _gj_solve(cfg: A1Config, prob, scal, mu, settings, kkt_inverse, *,
              rescue_capacity: int, rescue_iters: int):
    """Per-tick refactor: ``kkt_inverse`` of every scenario's scaled KKT
    ('reduced': the contact-pattern-reduced inverse; the others:
    ``_KKT_INVERSES``), the fused
    ADMM, and a flip-rescue continuation of the worst
    ``rescue_capacity`` unconverged or flagged scenarios."""
    dtype, dev = prob.q_vec.dtype, prob.q_vec.device
    a0, a1 = srb.friction_constraint_basis(cfg.horizon, dtype, dev)
    base_blk, slope_blk = srb.friction_basis_blocks(dtype, dev)
    m_b = qpx.scaled_kkt_matrix_blockdiag(
        prob.p_mat, base_blk, slope_blk, mu, prob.lb, prob.ub, settings,
        prob.rho0, scal)
    minv = kkt_inverse(m_b)
    sol = qpx.admm_solve_fixed_batched_shared(
        prob.p_mat, prob.q_vec, a0, a1, mu, prob.lb, prob.ub,
        cfg.mpc_qp_iters, settings, prob.warm_x, prob.warm_y, prob.rho0,
        scal, minv)
    if rescue_capacity > 0:
        need = (~sol.converged) | prob.rescue_flag
        score = need.to(dtype) * (
            1.0 + torch.maximum(sol.prim_res, sol.dual_res))
        ridx = top_k_indices(score, min(rescue_capacity, score.shape[0]))
        sol_r = qpx.admm_solve_fixed_batched_shared(
            prob.p_mat[ridx], prob.q_vec[ridx], a0, a1, mu[ridx],
            prob.lb[ridx], prob.ub[ridx], rescue_iters, settings,
            sol.x[ridx], sol.y[ridx], prob.rho0[ridx], _take(scal, ridx),
            minv[ridx])
        unconv = need[ridx]
        sol = _merge(sol, sol_r, ridx, unconv)
        rescued = torch.zeros_like(need)
        rescued[ridx] = unconv
        sol = sol.replace(iters=cfg.mpc_qp_iters + torch.where(
            rescued, rescue_iters, 0).to(torch.int32))
    return sol


@tensorclass
class LiveBlocks:
    """A problem gathered to its first ``n_rb`` live (step, leg) blocks,
    live-first in block order: 3 variables and 5 constraint rows each."""

    var_idx: torch.Tensor    # (B, 3 n_rb) variable indices
    row_idx: torch.Tensor    # (B, 5 n_rb) constraint-row indices
    p: torch.Tensor
    q: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor
    warm_x: torch.Tensor
    warm_y: torch.Tensor
    scal: qpx.Scaling


def gather_live_blocks(prob, scal, live_blk: torch.Tensor,
                       n_rb: int) -> LiveBlocks:
    """Gather ``prob`` (and its scaling) to the live-first ``n_rb``
    blocks of the (B, 4H) step-major block mask ``live_blk``; a scenario
    with fewer live blocks picks up dead ones at the tail."""
    b = live_blk.shape[0]
    dev = live_blk.device
    idxb = qpx.live_first(live_blk, n_rb)
    var_idx = (3 * idxb[:, :, None]
               + torch.arange(3, device=dev)).reshape(b, 3 * n_rb)
    row_idx = (5 * idxb[:, :, None]
               + torch.arange(5, device=dev)).reshape(b, 5 * n_rb)
    tv = lambda a: torch.gather(a, 1, var_idx)
    tr = lambda a: torch.gather(a, 1, row_idx)
    return LiveBlocks(
        var_idx=var_idx, row_idx=row_idx,
        p=qpx.gather_square(prob.p_mat, var_idx), q=tv(prob.q_vec),
        l=tr(prob.lb), u=tr(prob.ub), warm_x=tv(prob.warm_x),
        warm_y=tr(prob.warm_y),
        scal=qpx.Scaling(d=tv(scal.d), e=tr(scal.e), c=scal.c))


def _reduced_shared_solve(cfg: A1Config, prob, scal, mu, contacts,
                          settings, *, reduced_blocks: int,
                          big_capacity: int, rescue_capacity: int,
                          rescue_iters: int, polish_due=None):
    """The whole solve (KKT inverse and fused ADMM) at the gathered
    stance-block shape: a trot's 22 live blocks are 66 variables and 110
    rows instead of 40 blocks, 120 and 200. Exact, not approximate: dead
    (swing) variables have no cost coupling, unit P diagonal, zero q and
    loosened rows, and a dead variable warm-started at 0 stays 0 through
    every ADMM iteration, so dropping it changes no live iterate; the
    gathered blocks keep the shared constraint basis at the reduced
    block count.

    Scenarios with more than ``reduced_blocks`` live blocks (3-4 stance
    legs) are solved at full size in a ``big_capacity`` bucket and
    scattered in; when more than ``big_capacity`` of them exist, the
    whole batch takes the full-size path (one host read). Each tier
    runs two rho-refactored rescue rounds (``_gathered_rescue``), the
    second only when a scenario is still unconverged (one host read
    each). The full-size path also carries the round-robin polish."""
    b, n = prob.q_vec.shape
    m_rows = prob.lb.shape[1]
    h = cfg.horizon
    dtype, dev = prob.q_vec.dtype, prob.q_vec.device
    nblk = n // 3
    n_rb = min(reduced_blocks, nblk)
    base_blk, slope_blk = srb.friction_basis_blocks(dtype, dev)
    a0f, a1f = srb.friction_constraint_basis(h, dtype, dev)
    iters = cfg.mpc_qp_iters

    live_blk = srb.tile_last(contacts, h)            # (B, 4H) step-major
    n_live_blk = torch.sum(live_blk, dim=1)

    def rescue(sol, p_of, q_of, l_of, u_of, scal_of, a0, a1, mu_v,
               small_inverse, cap=None, unconverged_only=False,
               rescue_flag=None, rho0_base=None, eligible=None):
        """``_gathered_rescue`` at this solve's settings; ``rescue_flag``
        and ``rho0_base`` default to the full batch's."""
        return _gathered_rescue(
            sol, p_of, q_of, l_of, u_of, scal_of, a0, a1, mu_v,
            small_inverse, settings,
            cap=min(cap or rescue_capacity, sol.x.shape[0]),
            rescue_iters=rescue_iters,
            rescue_flag=(prob.rescue_flag if rescue_flag is None
                         else rescue_flag),
            rho0_base=prob.rho0 if rho0_base is None else rho0_base,
            base_blk=base_blk, slope_blk=slope_blk, eligible=eligible,
            unconverged_only=unconverged_only)

    def full_path():
        m_b = qpx.scaled_kkt_matrix_blockdiag(
            prob.p_mat, base_blk, slope_blk, mu, prob.lb, prob.ub,
            settings, prob.rho0, scal)
        minv = batched_inverse(m_b)
        sol = qpx.admm_solve_fixed_batched_shared(
            prob.p_mat, prob.q_vec, a0f, a1f, mu, prob.lb, prob.ub,
            iters, settings, prob.warm_x, prob.warm_y, prob.rho0, scal,
            minv)
        if rescue_capacity > 0:
            full = (prob.p_mat, prob.q_vec, prob.lb, prob.ub, scal, a0f,
                    a1f, mu, batched_inverse)
            sol = rescue(sol, *full)
            if not host_bool(torch.all(sol.converged)):
                sol = rescue(sol, *full, cap=max(8, rescue_capacity // 4),
                             unconverged_only=True)
        if polish_due is not None:
            due = polish_due & ~prob.rescue_flag
            cap_p = max(1, -(-b // cfg.mpc_polish_every))
            sol, _ = _gathered_polish(
                sol, prob.p_mat, prob.q_vec, prob.lb, prob.ub, scal, a0f,
                a1f, mu, minv, prob.rho0, settings, due=due, cap=cap_p,
                iters=cfg.mpc_polish_iters)
        return sol

    def reduced_path():
        r = gather_live_blocks(prob, scal, live_blk, n_rb)
        p_r, q_r, l_r, u_r, scal_r = r.p, r.q, r.l, r.u, r.scal
        m_r = qpx.scaled_kkt_matrix_blockdiag(
            p_r, base_blk, slope_blk, mu, l_r, u_r, settings, prob.rho0,
            scal_r)
        a0r, a1r = srb.friction_constraint_basis_nblk(n_rb, dtype, dev)
        sol_r = qpx.admm_solve_fixed_batched_shared(
            p_r, q_r, a0r, a1r, mu, l_r, u_r, iters, settings, r.warm_x,
            r.warm_y, prob.rho0, scal_r, batched_inverse_small(m_r))
        if rescue_capacity > 0:
            # big-bucket scenarios are not eligible: their reduced result
            # is overwritten below, and they would starve the tier's own
            # stragglers of slots
            red = (p_r, q_r, l_r, u_r, scal_r, a0r, a1r, mu,
                   batched_inverse_small)
            red_tier = n_live_blk <= n_rb
            sol_r = rescue(sol_r, *red, eligible=red_tier)
            if not host_bool(torch.all(sol_r.converged | ~red_tier)):
                sol_r = rescue(sol_r, *red,
                               cap=max(8, rescue_capacity // 4),
                               unconverged_only=True, eligible=red_tier)

        # scatter back to full coordinates (dead entries are exactly 0
        # in the equivalent full solve)
        def scatter(v, idx, width):
            return v.new_zeros((b, width)).scatter_(1, idx, v)
        sol = sol_r.replace(x=scatter(sol_r.x, r.var_idx, n),
                            y=scatter(sol_r.y, r.row_idx, m_rows),
                            z=scatter(sol_r.z, r.row_idx, m_rows))

        # the full-size big bucket: the big_capacity scenarios with the
        # most live blocks, which holds every one beyond the reduced tier
        # (else the overflow test took the full path)
        big_idx = top_k_indices(n_live_blk, big_capacity)
        tkb = lambda a: a[big_idx]
        scal_b = _take(scal, big_idx)
        p_b, q_b, mu_b = tkb(prob.p_mat), tkb(prob.q_vec), tkb(mu)
        l_b, u_b, rho_b = tkb(prob.lb), tkb(prob.ub), tkb(prob.rho0)
        m_bc = qpx.scaled_kkt_matrix_blockdiag(
            p_b, base_blk, slope_blk, mu_b, l_b, u_b, settings, rho_b,
            scal_b)
        sol_b = qpx.admm_solve_fixed_batched_shared(
            p_b, q_b, a0f, a1f, mu_b, l_b, u_b, iters, settings,
            tkb(prob.warm_x), tkb(prob.warm_y), rho_b, scal_b,
            batched_inverse(m_bc))
        if rescue_capacity > 0:
            big = (p_b, q_b, l_b, u_b, scal_b, a0f, a1f, mu_b,
                   batched_inverse)
            kw = dict(rescue_flag=tkb(prob.rescue_flag), rho0_base=rho_b)
            sol_b = rescue(sol_b, *big, cap=max(8, big_capacity // 2), **kw)
            if not host_bool(torch.all(sol_b.converged)):
                sol_b = rescue(sol_b, *big, cap=max(8, big_capacity // 4),
                               unconverged_only=True, **kw)
        return _put(sol, big_idx, sol_b)

    if big_capacity >= b or n_rb >= nblk:
        return full_path()
    if host_bool(torch.sum(n_live_blk > n_rb) > big_capacity):
        return full_path()
    return reduced_path()


def _dense_solve(cfg: A1Config, prob, scal, settings, *, use_pallas: bool,
                 admm_backend: str):
    """The routes with the materialized A: per-scenario scaled KKT,
    inverted by K1 (``use_pallas``) or ``torch.linalg.inv``, then the
    fused ADMM with per-scenario A (K4, 'pallas') or the batched
    ``admm_solve_fixed`` with that inverse ('xla'). No rescue."""
    m_b = qpx.scaled_kkt_matrix(prob.p_mat, prob.q_vec, prob.a_mat,
                                prob.lb, prob.ub, settings, prob.rho0, scal)
    minv = batched_inverse(m_b) if use_pallas else torch.linalg.inv(m_b)
    if admm_backend == "pallas":     # K4 takes a row-major inverse
        return qpx.admm_solve_fixed_batched(
            prob.p_mat, prob.q_vec, prob.a_mat, prob.lb, prob.ub,
            cfg.mpc_qp_iters, settings, prob.warm_x, prob.warm_y,
            prob.rho0, scal, minv.contiguous())
    return qpx.admm_solve_fixed(
        prob.p_mat, prob.q_vec, prob.a_mat, prob.lb, prob.ub,
        cfg.mpc_qp_iters, settings, x0=prob.warm_x, y0=prob.warm_y,
        rho0=prob.rho0, scaling=scal, kkt_inv=minv)


# the full-size inverse of each per-tick-refactor route (``_gj_solve``)
_KKT_INVERSES = {
    "gj": batched_inverse,
    "chol": lambda m: linalg.spd_cholesky_inverse(m, panel=30),
    "schur": lambda m: retired.spd_block_inverse(m, base=32),
    "sweep_t": retired.batched_inverse_sweep_T_masked,
    "gj_t": retired.batched_inverse_T,
}
KKT_BACKENDS = ("amortized", "reduced", "reduced_admm", *_KKT_INVERSES)


def batched_control_tick(cfg: A1Config, params_b: RobotParams, cs_b, mem_b,
                         sensors_b, joy: JoyCmd, dt: torch.Tensor, *,
                         use_pallas: bool = False,
                         admm_backend: str = "xla",
                         kkt_backend: str = "gj",
                         kkt_reduced_nr: int = 64,
                         kkt_big_capacity: int = 256,
                         rescue_capacity: int = 0,
                         rescue_iters: int = 25,
                         kkt_carry: KktCarry | None = None,
                         kkt_amortize_capacity: int = 192,
                         kkt_refine_order: int = 2,
                         return_stats: bool = False):
    """One batched MPC tick with the KKT factorization and the whole ADMM
    loop hoisted out of the per-scenario code (routes: module
    docstring). Returns (cs, mem, torques) [+ KktCarry on 'amortized']
    [+ stats]; unlike the JAX package, the 'pallas' and 'xla' routes
    return stats too when asked."""
    if admm_backend not in ("pallas_shared", "pallas", "xla"):
        raise ValueError(f"unknown admm_backend={admm_backend!r}")
    if admm_backend == "pallas_shared" and kkt_backend not in KKT_BACKENDS:
        raise ValueError(f"unknown kkt_backend={kkt_backend!r}; known: "
                         + ", ".join(map(repr, KKT_BACKENDS)))
    assert cfg.mpc_solver_mode == "fixed"
    settings = qpx.QPSettings(rho=grf._MPC_RHO0, adaptive_rho=False)

    cs, mem, prob = control_tick_build(
        cfg, params_b, cs_b, mem_b, sensors_b, joy, dt,
        with_a_mat=admm_backend != "pallas_shared")
    scal = qpx.rescale_cost(
        prob.p_mat, prob.q_vec,
        grf.scaling_for_contacts(mem.mpc_scaling_table, cs.contacts))
    mu = params_b.mu_mpc
    rescue = dict(rescue_capacity=rescue_capacity, rescue_iters=rescue_iters)

    extras = ()
    if admm_backend != "pallas_shared":
        sol = _dense_solve(cfg, prob, scal, settings, use_pallas=use_pallas,
                           admm_backend=admm_backend)
    elif kkt_backend == "amortized":
        assert kkt_carry is not None, \
            "kkt_backend='amortized' needs a threaded kkt_carry " \
            "(parallel.batched.make_kkt_carry)"
        sol, kcarry = _amortized_full_solve(
            cfg, prob, scal, mu, settings, kkt_carry,
            capacity=kkt_amortize_capacity, refine_order=kkt_refine_order,
            polish_due=polish_due_mask(cfg, mem), **rescue)
        extras = (kcarry,)
    elif kkt_backend == "reduced_admm":
        sol = _reduced_shared_solve(
            cfg, prob, scal, mu, cs.contacts, settings,
            reduced_blocks=max(2, (kkt_reduced_nr + 2) // 3),
            big_capacity=kkt_big_capacity,
            polish_due=polish_due_mask(cfg, mem), **rescue)
    elif kkt_backend == "reduced":
        live = srb.tile_last(cs.contacts.repeat_interleave(3, dim=1),
                             cfg.horizon)
        sol = _gj_solve(cfg, prob, scal, mu, settings,
                        lambda m: qpx.reduced_kkt_inverse(
                            m, live, n_r=kkt_reduced_nr,
                            big_capacity=kkt_big_capacity), **rescue)
    else:
        sol = _gj_solve(cfg, prob, scal, mu, settings,
                        _KKT_INVERSES[kkt_backend], **rescue)
    out = control_tick_finish(cfg, params_b, cs, mem, sol) + extras
    if return_stats:
        out = out + ({"converged": sol.converged, "prim_res": sol.prim_res,
                      "dual_res": sol.dual_res},)
    return out


def batched_stand_control_tick(cfg: A1Config, params_b: RobotParams, cs_b,
                               mem_b, sensors_b, joy: JoyCmd,
                               dt: torch.Tensor, *,
                               rescue_capacity: int = 128,
                               rescue_iters: int = 400,
                               return_stats: bool = False):
    """Lock-step batched stand-QP tick (the reference's QP balance path,
    A1RobotControl.cpp:416-431): the batched build, a fixed
    ``cfg.stand_qp_iters``-iteration warm-started ADMM for every
    scenario, then, unless every scenario converged (one host read,
    ``tensors.host_syncs``), a rescue of the worst ``rescue_capacity``
    unconverged ones: ``rescue_iters`` more iterations at 1e-5 from the
    first pass's iterate, at its rho estimate clipped to [1e-3, 1],
    merged only where the first pass failed. Needs a stand-QP profile in
    fixed mode. Returns (cs, mem, torques) [+ stats: the JAX package's
    converged, prim_res, dual_res, iters, and the first pass's converged
    and whether the rescue ran]."""
    assert cfg.stance_leg_control_type == 0
    assert cfg.mpc_solver_mode == "fixed"
    cs, mem, prob = control_tick_build_qp(cfg, params_b, cs_b, mem_b,
                                          sensors_b, joy, dt)

    def solve(pr, iters, eps, x0, y0, rho0):
        return qpx.admm_solve_fixed(
            pr.p_mat, pr.q_vec, pr.a_mat, pr.lb, pr.ub, iters,
            qpx.QPSettings(rho=grf._QP_RHO0, eps_abs=eps, eps_rel=eps),
            x0=x0, y0=y0, rho0=rho0)

    sol = solve(prob, cfg.stand_qp_iters, 1e-4, prob.warm_x, prob.warm_y,
                prob.rho0)
    first_converged = sol.converged
    rescued = (rescue_capacity > 0
               and not host_bool(torch.all(sol.converged)))
    if rescued:
        score = torch.where(sol.converged, 0.0,
                            torch.maximum(sol.prim_res, sol.dual_res))
        ridx = top_k_indices(score, min(rescue_capacity, score.shape[0]))
        sol_r = solve(_take(prob, ridx), rescue_iters, 1e-5, sol.x[ridx],
                      sol.y[ridx], torch.clamp(sol.rho[ridx], 1e-3, 1.0))
        sol = _merge(sol, sol_r, ridx, ~sol.converged[ridx])
    out = control_tick_finish_qp(cfg, params_b, cs, mem, sol)
    if return_stats:
        out = out + ({"converged": sol.converged, "prim_res": sol.prim_res,
                      "dual_res": sol.dual_res, "iters": sol.iters,
                      "first_converged": first_converged,
                      "rescued": rescued},)
    return out


def batched_closed_loop_step(cfg: A1Config, params_b: RobotParams, terr_b,
                             carry: cl.LoopCarry, joy: JoyCmd, dt,
                             substeps: int = 5, *, device=CUDA,
                             **tick_kwargs):
    """One closed-loop batched step: read_sensors -> batched_control_tick
    -> plant_step. Returns the new carry [+ KktCarry] [+ stats], as the
    JAX package does."""
    device = check_on(device, carry.ps.root_pos)
    if not torch.is_tensor(dt):
        dt = const(float(dt), carry.ps.root_pos.dtype, device)
    sensors = plant_mod.read_sensors(params_b, carry.ps,
                                     carry.prev_root_lin_vel, dt)
    out = batched_control_tick(cfg, params_b, carry.cs, carry.mem, sensors,
                               joy, dt, **tick_kwargs)
    cs, mem, tq = out[:3]
    ps = plant_mod.plant_step(params_b, terr_b, carry.ps, tq, dt, substeps)
    new_carry = cl.LoopCarry(cs=cs, mem=mem, ps=ps,
                             prev_root_lin_vel=carry.ps.root_lin_vel)
    return (new_carry,) + tuple(out[3:]) if len(out) > 3 else new_carry


def batched_stand_closed_loop_step(cfg: A1Config, params_b: RobotParams,
                                   terr_b, carry: cl.LoopCarry, joy: JoyCmd,
                                   dt, substeps: int = 5, *, device=CUDA,
                                   **tick_kwargs):
    """One closed-loop stand-QP step: read_sensors ->
    batched_stand_control_tick -> plant_step (the loop of the JAX
    package's ``run_stand_batched_gate``). Returns the new carry
    [+ stats]."""
    device = check_on(device, carry.ps.root_pos)
    if not torch.is_tensor(dt):
        dt = const(float(dt), carry.ps.root_pos.dtype, device)
    sensors = plant_mod.read_sensors(params_b, carry.ps,
                                     carry.prev_root_lin_vel, dt)
    out = batched_stand_control_tick(cfg, params_b, carry.cs, carry.mem,
                                     sensors, joy, dt, **tick_kwargs)
    ps = plant_mod.plant_step(params_b, terr_b, carry.ps, out[2], dt,
                              substeps)
    new_carry = cl.LoopCarry(cs=out[0], mem=out[1], ps=ps,
                             prev_root_lin_vel=carry.ps.root_lin_vel)
    return (new_carry,) + tuple(out[3:]) if len(out) > 3 else new_carry


def randomize_params(generator: torch.Generator, n: int,
                     base: RobotParams, device=CUDA) -> RobotParams:
    """Per-scenario randomization: mass and inertia +-20%, controller mu
    in [0.2, 0.45], gait speed +-20%, swing-PD gain +-15%. Draws come
    from ``generator`` (on its own device) and are moved to ``device``."""
    device = check_on(device, base.robot_mass)
    gdev = generator.device

    def u(lo, hi):
        r = torch.rand((n,), generator=generator, device=gdev,
                       dtype=base.robot_mass.dtype)
        return (lo + (hi - lo) * r).to(device)

    batched = broadcast_batch(base, n)
    mass_scale, inertia_scale = u(0.8, 1.2), u(0.8, 1.2)
    mu, gait_scale, kp_scale = u(0.2, 0.45), u(0.8, 1.2), u(0.85, 1.15)
    return batched.replace(
        robot_mass=batched.robot_mass * mass_scale,
        trunk_inertia=batched.trunk_inertia * inertia_scale[:, None, None],
        mu_mpc=mu,
        gait_counter_speed=batched.gait_counter_speed * gait_scale[:, None],
        kp_foot=batched.kp_foot * kp_scale[:, None, None],
    )


def make_flat_batch(cfg: A1Config, generator: torch.Generator, n: int,
                    base: RobotParams, device=CUDA):
    """Randomized params + flat terrain + standing-start carry: the
    closed-loop throughput batch. Returns (params, terrain, carry)."""
    params = randomize_params(generator, n, base, device=device)
    terr = terrain_mod.Terrain.flat(n, device=device)
    carry = cl.make_standing_start(cfg, params, terr, device=device)
    return params, terr, carry
