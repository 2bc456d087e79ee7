"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; that version is
held against the Pallas kernel run in interpret mode on KKT-family
inputs from a real tick (``make_bench_state``). The ``cuda``-marked tests
hold each CUDA kernel against its plain version on the card and skip
without one; JAX is imported only inside the CPU tests, so on a machine
without JAX they run with ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels

from torch_parity import bench_state, t

B = 3


@pytest.fixture(scope="module")
def jax_tick():
    """Scaled KKT matrices and ADMM operands of one real gazebo_mpc tick
    (trot command from the physical bench state), built by the JAX
    package, plus the Pallas K1 result on them."""
    import jax
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.config import load_profile
    from a1_qp_mpc_controller_tpu.control import grf
    from a1_qp_mpc_controller_tpu.control.controller import (
        control_tick_build,
    )
    from a1_qp_mpc_controller_tpu.models import srb
    from a1_qp_mpc_controller_tpu.ops import qp as qpx
    from a1_qp_mpc_controller_tpu.ops.pallas_kernels import batched_inverse
    from a1_qp_mpc_controller_tpu.types import JoyCmd

    cfg, params = load_profile("gazebo_mpc")
    cfg = dataclasses.replace(cfg, mpc_qp_iters=25, mpc_solver_mode="fixed")
    pb, cs, mem, sens = bench_state(cfg, 4, B, params)
    joy = JoyCmd.zeros().replace(ctrl_state=jnp.int32(1),
                                 velx=jnp.float32(0.2))
    dt = jnp.float32(cfg.control_dt)
    settings = qpx.QPSettings(rho=grf._MPC_RHO0, adaptive_rho=False)

    @jax.jit
    def build(pb, cs, mem, sens):
        cs, mem, prob = jax.vmap(lambda p, c, m, s: control_tick_build(
            cfg, p, c, m, s, joy, dt, with_a_mat=False))(pb, cs, mem, sens)
        scal = jax.vmap(lambda tb, c, p, q: qpx.rescale_cost(
            p, q, grf.scaling_for_contacts(tb, c)))(
            mem.mpc_scaling_table, cs.contacts, prob.p_mat, prob.q_vec)
        base, slope = srb.friction_basis_blocks()
        m_b = qpx.scaled_kkt_matrix_blockdiag(
            prob.p_mat, base, slope, pb.mu_mpc, prob.lb, prob.ub, settings,
            prob.rho0, scal)
        ls, us = scal.e * prob.lb, scal.e * prob.ub
        rho_vec = jax.vmap(qpx._rho_vec, in_axes=(0, 0, 0, None))(
            ls, us, prob.rho0, settings.rho_eq_scale)
        qs = scal.c[:, None] * scal.d * prob.q_vec
        return m_b, scal, ls, us, rho_vec, qs

    m_b, scal, ls, us, rho_vec, qs = build(pb, cs, mem, sens)
    minv = batched_inverse(m_b, block=B, interpret=True)
    a0, a1 = srb.friction_constraint_basis(cfg.horizon)
    out = dict(m=m_b, minv=minv, a0=a0, a1=a1, mu=pb.mu_mpc, d=scal.d,
               e=scal.e, qs=qs, ls=ls, us=us, rho_vec=rho_vec)
    return {k: np.asarray(v) for k, v in out.items()}


def test_k1_plain_matches_pallas_interpret(jax_tick):
    """Same pivot sequence and arithmetic as ``_gj_inverse_kernel``:
    elementwise agreement to 1e-4 of the inverse's scale (the residual
    of the sequential Gauss-Jordan class on this family is ~1e-3, so
    rounding noise sits far below), and ||MX - I||_inf <= 1e-3."""
    m = jax_tick["m"]
    x = kernels.batched_inverse(t(m)).numpy()
    ref = jax_tick["minv"]
    assert np.abs(x - ref).max() <= 1e-4 * np.abs(ref).max()
    resid = np.abs(np.einsum("bij,bjk->bik", m.astype(np.float64), x)
                   - np.eye(m.shape[-1])).max()
    assert resid <= 1e-3, resid


def _warm_start(tick, rng):
    """A nonzero scaled-space warm start (x0, y0, z0 = clip(A x0))."""
    b, n = tick["qs"].shape
    x0 = (0.1 * rng.standard_normal((b, n))).astype(np.float32)
    y0 = (0.01 * rng.standard_normal(tick["ls"].shape)).astype(np.float32)
    a = tick["a0"][None] + tick["mu"][:, None, None] * tick["a1"][None]
    ax = tick["e"] * np.einsum("bmn,bn->bm", a, tick["d"] * x0)
    z0 = np.clip(ax, tick["ls"], tick["us"]).astype(np.float32)
    return x0, y0, z0


K2_ARGS = ("a0", "a1", "minv", "mu", "d", "e", "qs", "ls", "us", "rho_vec")


def test_k2_plain_matches_pallas_interpret(jax_tick, rng):
    """25 iterations from the same operands and warm start: the two
    versions sum the A-products in different orders, so they agree to
    float32 accumulation noise, 1e-4 of each output's scale."""
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.ops.pallas_kernels import fused_admm_shared

    x0, y0, z0 = _warm_start(jax_tick, rng)
    ops = [jax_tick[k] for k in K2_ARGS] + [x0, y0, z0]
    ref = fused_admm_shared(*[jnp.asarray(a) for a in ops], iters=25,
                            sigma=1e-6, alpha=1.6, block=B, interpret=True)
    out = kernels.fused_admm_shared(*[t(a) for a in ops], iters=25,
                                    sigma=1e-6, alpha=1.6)
    for name, o, r in zip("xyz", out, ref):
        r = np.asarray(r)
        err = np.abs(o.numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-4, (name, err)


def test_k2_packed_model_matches_pallas_interpret(jax_tick, rng):
    """The model of the packed kernel's arithmetic
    (``tests/test_torch_admm_packing.py``: the A-products from the packed
    nonzero lists, the matvec summed in float64) against the Pallas
    kernel in interpret mode, on the operands and warm start of the test
    above, at its limit."""
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.ops.pallas_kernels import fused_admm_shared

    from test_torch_admm_packing import kernel_model

    x0, y0, z0 = _warm_start(jax_tick, rng)
    ops = [jax_tick[k] for k in K2_ARGS] + [x0, y0, z0]
    ref = fused_admm_shared(*[jnp.asarray(a) for a in ops], iters=25,
                            sigma=1e-6, alpha=1.6, block=B, interpret=True)
    out = kernel_model(*[t(a) for a in ops], iters=25)
    for name, o, r in zip("xyz", out, ref):
        r = np.asarray(r)
        err = np.abs(o.numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-4, (name, err)


def _port_tick(device, b=8):
    """Scaled KKT matrices and ADMM operands of one real tick, built by
    the port alone (no JAX), on ``device``."""
    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    from a1_qp_mpc_controller_tpu_torch.control import grf
    from a1_qp_mpc_controller_tpu_torch.control.controller import (
        control_tick_build,
    )
    from a1_qp_mpc_controller_tpu_torch.models import srb
    from a1_qp_mpc_controller_tpu_torch.ops import qp as qpx
    from a1_qp_mpc_controller_tpu_torch.parallel import batched
    from a1_qp_mpc_controller_tpu_torch.sim import plant
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

    cfg, params = load_profile("gazebo_mpc", device=device)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=25, mpc_solver_mode="fixed")
    gen = torch.Generator().manual_seed(0)
    pb, terr, carry = batched.make_flat_batch(cfg, gen, b, params,
                                              device=device)
    joy = JoyCmd.zeros(device=device).replace(
        ctrl_state=torch.ones((), dtype=torch.int32, device=device),
        velx=torch.full((), 0.3, device=device))
    dt = torch.full((), cfg.control_dt, device=device)
    sens = plant.read_sensors(pb, carry.ps, carry.prev_root_lin_vel, dt)
    cs, mem, prob = control_tick_build(cfg, pb, carry.cs, carry.mem, sens,
                                       joy, dt)
    scal = qpx.rescale_cost(prob.p_mat, prob.q_vec, grf.scaling_for_contacts(
        mem.mpc_scaling_table, cs.contacts))
    settings = qpx.QPSettings(rho=grf._MPC_RHO0, adaptive_rho=False)
    base, slope = srb.friction_basis_blocks(torch.float32, device)
    m_b = qpx.scaled_kkt_matrix_blockdiag(prob.p_mat, base, slope,
                                          pb.mu_mpc, prob.lb, prob.ub,
                                          settings, prob.rho0, scal)
    a0, a1 = srb.friction_constraint_basis(cfg.horizon, torch.float32,
                                           device)
    ls, us = scal.e * prob.lb, scal.e * prob.ub
    return dict(m=m_b, a0=a0, a1=a1, mu=pb.mu_mpc, d=scal.d, e=scal.e,
                qs=scal.c[:, None] * scal.d * prob.q_vec, ls=ls, us=us,
                rho_vec=qpx._rho_vec(ls, us, prob.rho0))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(card):
    m = _port_tick(card)["m"]
    before = kernels.launches["batched_inverse"]
    x = kernels.batched_inverse(m)
    torch.cuda.synchronize()
    assert kernels.launches["batched_inverse"] == before + 1
    ref = kernels.batched_inverse_plain(m)
    assert (x - ref).abs().max() <= 1e-4 * ref.abs().max()
    eye = torch.eye(m.shape[-1], dtype=torch.float64, device=card)
    assert (m.double() @ x.double() - eye).abs().max() <= 1e-3


@pytest.mark.cuda
def test_k2_kernel_matches_plain_on_card(card):
    tick = _port_tick(card)
    tick["minv"] = kernels.batched_inverse_plain(tick.pop("m"))
    b, n = tick["qs"].shape
    gen = torch.Generator(device=card).manual_seed(1)
    x0 = 0.1 * torch.randn((b, n), generator=gen, device=card)
    y0 = 0.01 * torch.randn(tick["ls"].shape, generator=gen, device=card)
    z0 = torch.zeros_like(y0)
    ops = [tick[k] for k in K2_ARGS] + [x0, y0, z0]
    out = kernels.fused_admm_shared(*ops, iters=25)
    torch.cuda.synchronize()
    ref = kernels.fused_admm_shared_plain(*ops, iters=25, sigma=1e-6,
                                          alpha=1.6)
    for name, o, r in zip("xyz", out, ref):
        err = float((o - r).abs().max() / r.abs().max())
        assert err <= 1e-4, (name, err)


def _k2_operands(b, n_blk, kind, device, seed=0):
    """K2's operands at n = 3 n_blk, m = 5 n_blk: the friction basis
    ('basis'), the basis with a second nonzero in a row of each block
    ('wide': every list as short as the basis's, but not within its
    widths) or dense random A0/A1 ('dense') of its shape, and a
    consistent scaled QP (minv the
    inverse of P + sigma I + A_s' diag(rho) A_s, in float64), so that 150
    iterations converge rather than amplify rounding. The bounds are
    tight enough that rows are active even at B = 1: where none is, y
    falls to the rounding floor of y + rho (zp - z) and holds no digit
    that two summation orders share."""
    from a1_qp_mpc_controller_tpu_torch.models import srb

    rng = np.random.default_rng(seed)
    a0, a1 = srb.friction_constraint_basis_nblk(n_blk, torch.float64, "cpu")
    m, n = a0.shape
    if kind == "wide":
        a0[4::5, 0::3] += 0.5 * torch.eye(n_blk, dtype=torch.float64)
    elif kind == "dense":
        a0, a1 = (torch.tensor(0.3 * rng.standard_normal((m, n)))
                  for _ in range(2))
    g = lambda *s: torch.tensor(rng.standard_normal(s))
    mu = 0.4 + 0.4 * torch.tensor(rng.random(b))
    d, e = 0.5 + g(b, n).abs(), 0.5 + g(b, m).abs()
    rho = 0.1 + torch.tensor(rng.random((b, m)))
    q = g(b, n, n)
    a_s = e[:, :, None] * (a0 + mu[:, None, None] * a1) * d[:, None, :]
    kkt = (q @ q.transpose(1, 2) / n + torch.eye(n) * (1.0 + 1e-6)
           + a_s.transpose(1, 2) @ (rho[:, :, None] * a_s))
    ops = dict(a0=a0, a1=a1, minv=torch.linalg.inv(kkt), mu=mu, d=d, e=e,
               qs=g(b, n), ls=-0.1 - 0.2 * g(b, m).abs(),
               us=0.1 + 0.2 * g(b, m).abs(),
               rho_vec=rho, x0=0.1 * g(b, n), y0=0.01 * g(b, m),
               z0=0.1 * g(b, m))
    return {k: v.float().contiguous().to(device) for k, v in ops.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 37, 133, 1024])
@pytest.mark.parametrize("kind", ["basis", "wide", "dense"])
@pytest.mark.parametrize("n_blk", [44, 40, 22, 10, 4],
                         ids=["n132", "n120", "n66", "n30", "n12"])
def test_k2_kernel_matches_plain_on_shapes(card, n_blk, kind, b):
    """The packed kernel against its plain version at 0, 1, 25 and 150
    iterations, at the full and reduced widths, two small ones (the
    68-wide register tier) and one past 120 (minv in shared memory), on
    each way it reads the lists: the friction basis (its padded slots in
    shared memory) and the wide basis and dense random A0/A1 (the
    strided lists in device memory): K2's limit, 1e-4 of each output's
    scale; 0 iterations return the warm start as it is; one launch
    counted a call."""
    ops = _k2_operands(b, n_blk, kind, card)
    for iters in (0, 1, 25, 150):
        before = kernels.launches["fused_admm_shared"]
        out = kernels.fused_admm_shared(**ops, iters=iters)
        torch.cuda.synchronize()
        assert kernels.launches["fused_admm_shared"] == before + 1
        ref = kernels.fused_admm_shared_plain(**ops, iters=iters,
                                              sigma=1e-6, alpha=1.6)
        for name, o, r in zip("xyz", out, ref):
            assert bool(torch.isfinite(o).all()), (name, iters)
            if iters == 0:
                assert torch.equal(o, r), name
            err = float((o - r).abs().max() / r.abs().max())
            assert err <= 1e-4, (name, iters, err)
