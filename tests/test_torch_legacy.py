"""The legacy batched route (``admm_backend='pallas'``): the materialized
per-scenario constraint matrix, K4 (``fused_admm``), the dense scaled KKT
and ``admm_solve_fixed_batched``, against the JAX package.

- ``mpc_problem(with_a_mat=True)``'s ``a_mat`` equals the JAX package's,
  and a JAX ``MpcProblem`` with and without ``a_mat`` converts;
- ``scaled_kkt_matrix`` and ``admm_solve_fixed_batched`` against JAX on
  one real tick (the first trot tick from ``torch_parity.stood_start``);
- K4's plain version against the Pallas kernel in interpret mode (25
  iterations, relative 1e-4), with an inverse that is not symmetric;
- three closed-loop trot ticks on the route with the inverse by K1
  (``use_pallas``) and by a library inverse
  (``torch_parity.trot_ticks_match``).

The ``cuda``-marked test holds the K4 kernel against its plain version
on the card and skips without one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops import qp as tqp
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb

from torch_parity import (
    assert_close, count_calls, stood_start, t, to_port, trot_ticks_match,
)

B = 2
K4_ARGS = ("minv", "a_s", "qs", "ls", "us", "rho_vec", "x0", "y0", "z0")


@pytest.fixture(scope="module")
def start():
    return stood_start(B, dict(rescue_capacity=B, rescue_iters=150))


@pytest.fixture(scope="module")
def tick(start):
    """The first trot tick's QP from the stood-up state, built by the
    port with and without ``a_mat``, and its per-pattern scaling."""
    from a1_qp_mpc_controller_tpu_torch.control import grf
    from a1_qp_mpc_controller_tpu_torch.control.controller import (
        control_tick_build,
    )
    from a1_qp_mpc_controller_tpu_torch.sim import plant

    tc, c = start["tcfg"], start["tcarry"]
    dt = torch.full((), tc.control_dt)
    sens = plant.read_sensors(start["tpb"], c.ps, c.prev_root_lin_vel, dt)
    args = (tc, start["tpb"], c.cs, c.mem, sens, start["tjoy"], dt)
    cs, mem, prob = control_tick_build(*args, with_a_mat=True)
    scal = tqp.rescale_cost(prob.p_mat, prob.q_vec, grf.scaling_for_contacts(
        mem.mpc_scaling_table, cs.contacts))
    return dict(prob=prob, scal=scal, no_a=control_tick_build(*args)[2])


def _jax_problem(tick):
    """The tick's QP as the JAX package's ``MpcProblem`` and ``Scaling``."""
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.control import grf as jgrf
    from a1_qp_mpc_controller_tpu.ops import qp as jqp
    from a1_qp_mpc_controller_tpu_torch import convert

    as_jax = lambda obj: {k: jnp.asarray(v)
                          for k, v in convert.to_numpy(obj).items()}
    return (jgrf.MpcProblem(**as_jax(tick["prob"])),
            jqp.Scaling(**as_jax(tick["scal"])))


def test_a_mat_matches_jax_and_converts(start, tick):
    """The materialized constraint matrix is the JAX package's
    expression for it (``grf.mpc_problem``: the friction-cone matrix of
    each scenario's mu) to the bit; without ``with_a_mat`` there is
    none; a JAX ``MpcProblem`` converts with and without its ``a_mat``."""
    import jax

    from a1_qp_mpc_controller_tpu.models import srb as jsrb
    from a1_qp_mpc_controller_tpu_torch.control import grf

    ref = np.asarray(jax.vmap(lambda mu: jsrb.friction_constraint_matrix(
        mu, start["cfg"].horizon))(start["pb"].mu_mpc))
    assert ref.shape == (B, 200, 120)
    np.testing.assert_array_equal(tick["prob"].a_mat.numpy(), ref)
    assert tick["no_a"].a_mat is None
    jprob, _ = _jax_problem(tick)
    conv = to_port(grf.MpcProblem, jprob)
    np.testing.assert_array_equal(conv.a_mat.numpy(), ref)
    np.testing.assert_array_equal(conv.p_mat.numpy(),
                                  tick["prob"].p_mat.numpy())
    assert to_port(grf.MpcProblem, jprob.replace(a_mat=None)).a_mat is None


def _scaled(tick):
    """The tick's QP as a dict of tensors, and its scaling."""
    prob = {k: getattr(tick["prob"], k) for k in (
        "p_mat", "q_vec", "a_mat", "lb", "ub", "warm_x", "warm_y", "rho0")}
    return prob, tick["scal"]


def test_scaled_kkt_and_legacy_solve_match_jax(tick):
    """The dense scaled KKT to 1e-5 of its scale (one product summed in
    another order); the 25-iteration solve from the tick's warm start
    through K4, given JAX's inverse of it: primal and dual to 2e-3 on the
    ~130 N force scale and convergence flags exactly, as
    tests/test_parallel.py holds the Pallas solve to the vmapped one; the
    rho estimate, a ratio of residuals near the rounding floor, within
    a factor 5."""
    import jax
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.control import grf
    from a1_qp_mpc_controller_tpu.ops import qp as jqp

    settings = jqp.QPSettings(rho=grf._MPC_RHO0, adaptive_rho=False)
    jp, js = _jax_problem(tick)
    m_ref = jax.vmap(lambda P, q, A, l, u, r, sc: jqp.scaled_kkt_matrix(
        P, q, A, l, u, settings, r, sc))(jp.p_mat, jp.q_vec, jp.a_mat,
                                         jp.lb, jp.ub, jp.rho0, js)
    minv_ref = jnp.linalg.inv(m_ref)
    ref = jqp.admm_solve_fixed_batched(
        jp.p_mat, jp.q_vec, jp.a_mat, jp.lb, jp.ub, 25, settings,
        jp.warm_x, jp.warm_y, jp.rho0, js, minv_ref, block=B,
        interpret=True)

    prob, scal = _scaled(tick)
    tset = tqp.QPSettings(rho=grf._MPC_RHO0, adaptive_rho=False)
    m_b = tqp.scaled_kkt_matrix(prob["p_mat"], prob["q_vec"], prob["a_mat"],
                                prob["lb"], prob["ub"], tset, prob["rho0"],
                                scal)
    m_ref = np.asarray(m_ref)
    assert_close(m_b, m_ref, atol=1e-5 * np.abs(m_ref).max())
    sol = tqp.admm_solve_fixed_batched(
        prob["p_mat"], prob["q_vec"], prob["a_mat"], prob["lb"], prob["ub"],
        25, tset, prob["warm_x"], prob["warm_y"], prob["rho0"], scal,
        t(minv_ref))
    assert_close(sol.x, ref.x, atol=2e-3)
    assert_close(sol.y, ref.y, atol=2e-3)
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    assert sol.iters.tolist() == [25] * B
    ratio = sol.rho.numpy() / np.asarray(ref.rho)
    assert (ratio > 0.2).all() and (ratio < 5.0).all(), ratio


def _k4_operands(prob, scal, minv, rng):
    """K4's scaled-space operands for a problem dict, a nonzero warm
    start (x0, y0, z0 = clip(A x0)) and the given inverse."""
    sp = tqp.apply_scaling(prob["p_mat"], prob["q_vec"], prob["a_mat"],
                           prob["lb"], prob["ub"], scal)
    b, n = sp.q.shape
    x0 = torch.tensor(0.1 * rng.standard_normal((b, n)), dtype=torch.float32,
                      device=sp.q.device)
    y0 = torch.tensor(0.01 * rng.standard_normal(sp.l.shape),
                      dtype=torch.float32, device=sp.q.device)
    z0 = torch.clamp(torch.einsum("bmn,bn->bm", sp.A, x0), sp.l, sp.u)
    return dict(minv=minv, a_s=sp.A, qs=sp.q, ls=sp.l, us=sp.u,
                rho_vec=tqp._rho_vec(sp.l, sp.u, prob["rho0"]), x0=x0,
                y0=y0, z0=z0)


def test_k4_plain_matches_pallas_interpret(tick, rng):
    """25 iterations from the same operands: the two versions sum the
    products in different orders, so they agree to float32 accumulation
    noise, 1e-4 of each output's scale. The inverse gets a 1% random
    perturbation, so that it is not symmetric and a reduction along the
    wrong axis of it would show."""
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.ops.pallas_kernels import fused_admm

    prob, scal = _scaled(tick)
    m_b = tqp.scaled_kkt_matrix(prob["p_mat"], prob["q_vec"], prob["a_mat"],
                                prob["lb"], prob["ub"], tqp.QPSettings(
                                    rho=3e-3, adaptive_rho=False),
                                prob["rho0"], scal)
    minv = torch.linalg.inv(m_b)
    minv = minv * (1.0 + 0.01 * torch.tensor(
        rng.standard_normal(minv.shape), dtype=torch.float32))
    assert (minv - minv.transpose(1, 2)).abs().max() > 1e-3 * minv.abs().max()
    ops = _k4_operands(prob, scal, minv, rng)
    ref = fused_admm(*[jnp.asarray(ops[k].numpy()) for k in K4_ARGS],
                     iters=25, sigma=1e-6, alpha=1.6, block=B,
                     interpret=True)
    out = kernels.fused_admm(*[ops[k] for k in K4_ARGS], iters=25)
    for name, o, r in zip("xyz", out, ref):
        r = np.asarray(r)
        err = np.abs(o.numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_legacy_route_three_ticks_match_jax(start, use_pallas, monkeypatch):
    """K4 every tick; the KKT inverse by K1 with ``use_pallas``, by the
    library inverse without; no rescue, no host read."""
    calls = count_calls(monkeypatch, ["batched_inverse", "fused_admm",
                                      "fused_admm_shared"], [tb, tqp])
    reads, _ = trot_ticks_match(start, dict(admm_backend="pallas",
                                            use_pallas=use_pallas))
    assert reads == [0, 0, 0]
    assert calls == {"batched_inverse": 3 if use_pallas else 0,
                     "fused_admm": 3, "fused_admm_shared": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k4_kernel_matches_plain_on_card(card):
    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    from a1_qp_mpc_controller_tpu_torch.control import grf
    from a1_qp_mpc_controller_tpu_torch.control.controller import (
        control_tick_build,
    )
    from a1_qp_mpc_controller_tpu_torch.sim import plant
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

    cfg, params = load_profile("gazebo_mpc", device=card)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=25, mpc_solver_mode="fixed")
    pb, terr, carry = tb.make_flat_batch(
        cfg, torch.Generator().manual_seed(0), 8, params, device=card)
    joy = JoyCmd.zeros(device=card).replace(
        ctrl_state=torch.ones((), dtype=torch.int32, device=card),
        velx=torch.full((), 0.3, device=card))
    dt = torch.full((), cfg.control_dt, device=card)
    sens = plant.read_sensors(pb, carry.ps, carry.prev_root_lin_vel, dt)
    cs, mem, p = control_tick_build(cfg, pb, carry.cs, carry.mem, sens, joy,
                                    dt, with_a_mat=True)
    scal = tqp.rescale_cost(p.p_mat, p.q_vec, grf.scaling_for_contacts(
        mem.mpc_scaling_table, cs.contacts))
    prob = {k: getattr(p, k) for k in ("p_mat", "q_vec", "a_mat", "lb", "ub",
                                       "rho0")}
    m_b = tqp.scaled_kkt_matrix(p.p_mat, p.q_vec, p.a_mat, p.lb, p.ub,
                                tqp.QPSettings(rho=3e-3, adaptive_rho=False),
                                p.rho0, scal)
    ops = _k4_operands(prob, scal, kernels.batched_inverse_plain(m_b),
                       np.random.default_rng(1))
    ops = {k: v.contiguous() for k, v in ops.items()}
    before = kernels.launches["fused_admm"]
    out = kernels.fused_admm(*[ops[k] for k in K4_ARGS], iters=25)
    torch.cuda.synchronize()
    assert kernels.launches["fused_admm"] == before + 1
    ref = kernels.fused_admm_plain(*[ops[k] for k in K4_ARGS], iters=25,
                                   sigma=1e-6, alpha=1.6)
    for name, o, r in zip("xyz", out, ref):
        err = float((o - r).abs().max() / r.abs().max())
        assert err <= 1e-4, (name, err)
