"""The contact-pattern-reduced solve: K3 (``batched_inverse_small``),
``ops/qp.reduced_kkt_inverse`` and the 'reduced_admm' route's big bucket,
against the JAX package.

- K3's plain version against the Pallas kernel in interpret mode on the
  live-block KKT matrices of a real tick, at the two reduced shapes the
  routes give it (64 and 66 variables);
- ``reduced_kkt_inverse`` against JAX on its reduced path (K3 plus a
  full-size bucket of 1) and on its overflow path (K1 on the batch), one
  JAX compile for both;
- the mixed-stance batch of tests/test_parallel.py (one scenario on four
  legs, two trotting): four ticks of ``batched_control_tick`` on
  'reduced_admm' with a big bucket of 2, so the bucket's count is 1,
  nonzero and under capacity, where truncating the four-legged scenario
  to the reduced tier would solve a wrong QP.

The ``cuda``-marked test holds the K3 kernel against its plain version
on the card, bit for bit (at both reduced shapes and at the Schur
recursion's base of 32), and skips without one.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch import tensors
from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops import qp as tqp
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb

from torch_parity import CPU, assert_close, bench_state, count_calls

B = 3
TROT_A = [True, False, False, True]
TROT_B = [False, True, True, False]
STAND = [True, True, True, True]
EARLY = [True, True, True, False]


def _eliminated_problem(patterns, device=CPU):
    """The swing-eliminated reference MPC problems of tests/
    test_parallel.py's ``_eliminated_kkt_batch``, one per contact
    pattern, with the per-pattern scaling; built by the port alone.
    Returns a dict of the problem's tensors and the (B, 4H) live-block
    mask."""
    from a1_qp_mpc_controller_tpu_torch.config import load_profile
    from a1_qp_mpc_controller_tpu_torch.control import grf
    from a1_qp_mpc_controller_tpu_torch.models import srb

    cfg, params = load_profile("gazebo_mpc", device=device)
    b = len(patterns)
    pb = tensors.broadcast_batch(params, b)
    c = torch.tensor(patterns, device=device)
    p0, q0, a0m, lb, ub = srb.reference_mpc_problem(pb, cfg.horizon)
    p2, q2, l2, u2 = srb.eliminate_swing(p0, q0, lb, ub, c, cfg.horizon)
    table = srb.reference_mpc_scaling_table(pb, cfg.horizon)
    return dict(
        p=p2, q=q2, a=a0m, l=l2, u=u2, mu=pb.mu_mpc,
        scal=tqp.rescale_cost(p2, q2, grf.scaling_for_contacts(table, c)),
        settings=tqp.QPSettings(rho=grf._MPC_RHO0, adaptive_rho=False),
        rho0=torch.full((b,), grf._MPC_RHO0, device=device),
        live_blk=srb.tile_last(c, cfg.horizon))


def _eliminated_kkt_batch(patterns, device=CPU):
    """Scaled KKT matrices (B, 120, 120) of the swing-eliminated family,
    one per contact pattern, and their (B, 120) live masks."""
    e = _eliminated_problem(patterns, device)
    m_b = tqp.scaled_kkt_matrix(e["p"], e["q"], e["a"], e["l"], e["u"],
                                e["settings"], e["rho0"], e["scal"])
    return m_b, e["live_blk"].repeat_interleave(3, dim=1)


def _live_blocks(m_b, live, n_r):
    """The live-first (B, n_r, n_r) gathers the reduced routes invert."""
    return tqp.gather_square(m_b, tqp.live_first(live, n_r)).contiguous()


@pytest.fixture(scope="module")
def mixed():
    """tests/test_parallel.py's mixed-stance bench state (B = 3): scenario
    1 with every gait counter in the stance half, 0 and 2 trotting."""
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.config import load_profile

    cfg, params = load_profile("gazebo_mpc")
    cfg = dataclasses.replace(cfg, mpc_qp_iters=25, mpc_solver_mode="fixed")
    pb, cs, mem, sens = bench_state(cfg, 4, B, params)
    gc = np.broadcast_to(np.array([30.0, 150.0, 150.0, 30.0]), (B, 4)).copy()
    gc[1] = [30.0, 60.0, 60.0, 30.0]
    cs = cs.replace(gait_counter=jnp.asarray(gc))
    return cfg, pb, cs, mem, sens


def _port_state(cfg, pb, cs, mem, sens):
    from a1_qp_mpc_controller_tpu_torch import config as tcfg
    from a1_qp_mpc_controller_tpu_torch import types as tt

    from torch_parity import to_port

    tc, _ = tcfg.load_profile("gazebo_mpc", device=CPU)
    tc = dataclasses.replace(tc, mpc_qp_iters=cfg.mpc_qp_iters,
                             mpc_solver_mode="fixed")
    return (tc, to_port(tcfg.RobotParams, pb), to_port(tt.CtrlState, cs),
            to_port(tt.CtrlMem, mem), to_port(tt.SensorData, sens))


@pytest.mark.parametrize("n_r", [64, 66])
def test_k3_plain_matches_pallas_interpret(mixed, n_r):
    """The live-block KKT matrices of the mixed batch's first trot tick
    (built by the port), gathered live-first to n_r: same pivot sequence
    and arithmetic as ``_gj_inverse_kernel``, so elementwise agreement to
    1e-4 of the inverse's scale, and ||MX - I||_max <= 1e-3."""
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.ops.pallas_kernels import (
        batched_inverse_small,
    )
    from a1_qp_mpc_controller_tpu_torch.control import grf
    from a1_qp_mpc_controller_tpu_torch.control.controller import (
        control_tick_build,
    )
    from a1_qp_mpc_controller_tpu_torch.models import srb
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

    tc, pb, cs, mem, sens = _port_state(*mixed)
    joy = JoyCmd.zeros(device=CPU).replace(
        ctrl_state=torch.ones((), dtype=torch.int32),
        velx=torch.full((), 0.2))
    cs, mem, prob = control_tick_build(tc, pb, cs, mem, sens, joy,
                                       torch.full((), tc.control_dt))
    scal = tqp.rescale_cost(prob.p_mat, prob.q_vec, grf.scaling_for_contacts(
        mem.mpc_scaling_table, cs.contacts))
    base, slope = srb.friction_basis_blocks(torch.float32, CPU)
    settings = tqp.QPSettings(rho=grf._MPC_RHO0, adaptive_rho=False)
    m_b = tqp.scaled_kkt_matrix_blockdiag(
        prob.p_mat, base, slope, pb.mu_mpc, prob.lb, prob.ub, settings,
        prob.rho0, scal)
    live = srb.tile_last(cs.contacts.repeat_interleave(3, dim=1), tc.horizon)
    m = _live_blocks(m_b, live, n_r)
    x = kernels.batched_inverse_small(m).numpy()
    ref = np.asarray(batched_inverse_small(jnp.asarray(m.numpy()), block=B,
                                           interpret=True))
    assert np.abs(x - ref).max() <= 1e-4 * np.abs(ref).max()
    resid = np.abs(np.einsum("bij,bjk->bik", m.numpy().astype(np.float64), x)
                   - np.eye(n_r)).max()
    assert resid <= 1e-3, resid
    with pytest.raises(ValueError, match="n=129"):
        kernels.batched_inverse_small(torch.zeros((1, 129, 129)))


def test_reduced_kkt_inverse_matches_jax_on_both_paths(monkeypatch):
    """Reduced path: one four-legged scenario fits the bucket of 1; the
    trotting ones go through K3 and the dead 3x3 blocks. Overflow path:
    three scenarios beyond the tier overflow the bucket, K1 inverts the
    batch. The port's result matches JAX's to 1e-4 of its scale (the
    same pivot sequences on identical inputs) and inverts M to 5e-3
    (tests/test_parallel.py's limit); one host read per call."""
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.ops import qp as jqp

    calls = count_calls(monkeypatch, ["batched_inverse",
                                      "batched_inverse_small"], [tqp])
    cases = {"reduced": [TROT_A, STAND, TROT_B, TROT_A],
             "overflow": [STAND, EARLY, TROT_A, STAND]}
    for path, patterns in cases.items():
        m_b, live = _eliminated_kkt_batch(patterns)
        before = tensors.host_syncs
        out = tqp.reduced_kkt_inverse(m_b, live, n_r=64, big_capacity=1)
        assert tensors.host_syncs - before == 1, path
        ref = np.asarray(jqp.reduced_kkt_inverse(
            jnp.asarray(m_b.numpy()), jnp.asarray(live.numpy()), n_r=64,
            big_capacity=1, block=2, small_block=2, interpret=True))
        assert_close(out, ref, atol=1e-4 * np.abs(ref).max(), err_msg=path)
        m64 = m_b.numpy().astype(np.float64)
        resid = np.abs(np.einsum("bij,bjk->bik", out.numpy(), m64)
                       - np.eye(120)).max()
        assert resid < 5e-3, (path, resid)
        if path == "reduced":    # dead rows carry no live coupling
            lm = live[0].numpy()
            assert np.abs(out[0].numpy()[~lm][:, lm]).max() == 0.0
    assert calls == {"batched_inverse": 2, "batched_inverse_small": 1}


def test_gathered_rescue_matches_jax_on_the_tier(monkeypatch):
    """``_gathered_rescue`` as the reduced tier calls it, on the same
    gathered operands in both packages: six problems gathered to the
    tier's 22 blocks after a 1-iteration first pass (every one
    unconverged). The stance and three-leg problems (2, 5) are not
    ``eligible`` (big-bucket scenarios) though their residuals rank
    highest; 0 and 3 are marked converged and flagged, so they keep
    ``rho0_base``, 1000x the stepsize for 3, whose reported residual is
    set a little below its true one so that its rescue is rejected; and
    the pool of 3 is smaller than the 4 that need a rescue. The port
    picks the same slots in the same order as ``lax.top_k`` (equal
    indices and gathered KKT matrices), accepts the same rescues and
    leaves every other scenario bit for bit. The accepted iterates and
    residuals agree to 1e-3 of their scale (the gathered inverse to 1e-4
    of its, amplified by the iterations from an unconverged start), the
    stepsize as the controller carries it (clamped) to 1e-3."""
    import jax
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.ops import pallas_kernels as pk
    from a1_qp_mpc_controller_tpu.ops import qp as jqp
    from a1_qp_mpc_controller_tpu.parallel import batched as jb
    from a1_qp_mpc_controller_tpu_torch import convert
    from a1_qp_mpc_controller_tpu_torch.models import srb

    e = _eliminated_problem([TROT_A, TROT_B, STAND, TROT_A, TROT_B, EARLY])
    b, n_rb, cap, iters = 6, 22, 3, 5
    e["mu"] = torch.linspace(0.25, 0.45, b)
    prob = SimpleNamespace(
        p_mat=e["p"], q_vec=e["q"], lb=e["l"], ub=e["u"],
        warm_x=torch.zeros_like(e["q"]), warm_y=torch.zeros_like(e["l"]))
    r = tb.gather_live_blocks(prob, e["scal"], e["live_blk"], n_rb)
    base, slope = srb.friction_basis_blocks(torch.float32, CPU)
    a0r, a1r = srb.friction_constraint_basis_nblk(n_rb, torch.float32, CPU)
    settings, rho0 = e["settings"], e["rho0"]
    m_r = tqp.scaled_kkt_matrix_blockdiag(r.p, base, slope, e["mu"], r.l,
                                          r.u, settings, rho0, r.scal)
    sol = tqp.admm_solve_fixed_batched_shared(
        r.p, r.q, a0r, a1r, e["mu"], r.l, r.u, 1, settings, r.warm_x,
        r.warm_y, rho0, r.scal, kernels.batched_inverse_small_plain(m_r))
    assert not bool(sol.converged.any())
    flag = (torch.arange(b) == 0) | (torch.arange(b) == 3)
    sol = sol.replace(converged=flag.clone(),
                      dual_res=torch.where(torch.arange(b) == 3, 1.15e-3,
                                           sol.dual_res))
    eligible = torch.sum(e["live_blk"], dim=1) <= n_rb
    assert eligible.tolist() == [True, True, False, True, True, False]
    rho_base = rho0 * torch.tensor([0.5, 0.8, 1.0, 1e3, 1.5, 2.0])
    ops = (r.p, r.q, r.l, r.u)

    picked, gathered = {}, {}

    def port_top_k(score, k):
        picked["port"] = tensors.top_k_indices(score, k)
        return picked["port"]

    def port_inverse(m):
        gathered["port"] = m
        return kernels.batched_inverse_small(m)

    monkeypatch.setattr(tb, "top_k_indices", port_top_k)
    out = tb._gathered_rescue(
        sol, *ops, r.scal, a0r, a1r, e["mu"], port_inverse, settings,
        cap=cap, rescue_iters=iters, rescue_flag=flag, rho0_base=rho_base,
        base_blk=base, slope_blk=slope, eligible=eligible)

    j = lambda v: jnp.asarray(v.numpy())
    jsol = jqp.QPSolution(**{key: jnp.asarray(v) for key, v in
                             convert.to_numpy(sol).items()})
    jscal = jqp.Scaling(d=j(r.scal.d), e=j(r.scal.e), c=j(r.scal.c))
    jset = jqp.QPSettings(rho=settings.rho, adaptive_rho=False)
    top_k = jax.lax.top_k

    def jrun(jsol):
        box = {}

        def rec_top_k(score, k):
            box["idx"] = top_k(score, k)[1]
            return top_k(score, k)

        def jinverse(m):
            box["m"] = m
            return pk.batched_inverse_small(m, block=cap, interpret=True)

        with monkeypatch.context() as mp:
            mp.setattr(jax.lax, "top_k", rec_top_k)
            res = jb._gathered_rescue(
                jsol, *map(j, ops), jscal, j(a0r), j(a1r), j(e["mu"]),
                jinverse, jset, cap=cap, rescue_iters=iters, admm_block=cap,
                interpret=True, rescue_flag=j(flag), rho0_base=j(rho_base),
                base_blk=j(base), slope_blk=j(slope), eligible=j(eligible))
        return res, box["idx"], box["m"]

    jout, jidx, jm = jax.jit(jrun)(jsol)
    np.testing.assert_array_equal(picked["port"].numpy(), np.asarray(jidx))
    assert sorted(picked["port"].tolist()) == [0, 1, 3]
    assert_close(gathered["port"], jm, atol=1e-5 * float(np.abs(jm).max()))
    accepted = (out.x != sol.x).any(dim=1)
    np.testing.assert_array_equal(
        accepted.numpy(), (np.asarray(jout.x) != sol.x.numpy()).any(axis=1))
    assert accepted.tolist() == [True, True, False, False, False, False]
    for name in ("x", "y", "z", "prim_res", "dual_res", "rho"):
        mine, ref = getattr(out, name), np.asarray(getattr(jout, name))
        np.testing.assert_array_equal(mine[~accepted].numpy(),
                                      getattr(sol, name)[~accepted].numpy())
        np.testing.assert_array_equal(ref[~accepted.numpy()],
                                      getattr(sol, name)[~accepted].numpy())
        if name == "rho":    # as the controller carries it
            lo, hi = 0.1 * settings.rho, 100.0 * settings.rho
            assert_close(mine.clamp(lo, hi), np.clip(ref, lo, hi),
                         atol=0.0, rtol=1e-3, err_msg=name)
        else:
            assert_close(mine, ref, atol=1e-3 * float(np.abs(ref).max()),
                         err_msg=name)
    for name in ("converged", "iters"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(jout, name)))


def test_reduced_admm_mixed_stance_big_bucket_matches_jax(mixed,
                                                          monkeypatch):
    """Four ticks on 'reduced_admm' (tier 64, big bucket 2) from the
    mixed bench state: torques 5e-3 N m and forces 0.05 N of the JAX
    package's same route (float32 noise of two implementations over four
    warm-carried ticks; a truncated four-legged scenario sits 2e-2 N m /
    0.12 N off and grows, tests/test_parallel.py), contacts exactly,
    one host read per tick (the overflow test), and the four-legged
    scenario solved at full size (K1) beside the reduced tier (K3)."""
    import jax
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.parallel import batched as jb
    from a1_qp_mpc_controller_tpu.types import JoyCmd as JJoy
    from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

    cfg, jpb, jcs, jmem, jsens = mixed
    tc, pb, cs, mem, sens = _port_state(*mixed)
    kw = dict(admm_backend="pallas_shared", kkt_backend="reduced_admm",
              kkt_reduced_nr=64, kkt_big_capacity=2)
    jjoy = JJoy.zeros().replace(ctrl_state=jnp.int32(1),
                                velx=jnp.float32(0.2))
    jdt = jnp.float32(cfg.control_dt)
    jtick = jax.jit(lambda c, m: jb.batched_control_tick(
        cfg, jpb, c, m, jsens, jjoy, jdt, kkt_block=B, admm_block=B,
        interpret=True, **kw))
    joy = JoyCmd.zeros(device=CPU).replace(
        ctrl_state=torch.ones((), dtype=torch.int32),
        velx=torch.full((), 0.2))
    dt = torch.full((), cfg.control_dt)
    calls = count_calls(monkeypatch, ["batched_inverse",
                                      "batched_inverse_small"], [tb])
    saw_mixed = False
    for tick in range(4):
        jcs, jmem, jtq = jtick(jcs, jmem)
        before = tensors.host_syncs
        cs, mem, tq = tb.batched_control_tick(tc, pb, cs, mem, sens, joy, dt,
                                              **kw)
        assert tensors.host_syncs - before == 1
        ns = np.asarray(jcs.contacts).sum(axis=1)
        saw_mixed = saw_mixed or ((ns > 2).any() and (ns <= 2).any())
        msg = f"tick {tick} (stance counts {ns})"
        np.testing.assert_array_equal(cs.contacts.numpy(),
                                      np.asarray(jcs.contacts), err_msg=msg)
        assert_close(tq, jtq, atol=5e-3, err_msg=msg)
        assert_close(cs.foot_forces_grf, jcs.foot_forces_grf, atol=0.05,
                     err_msg=msg)
    assert saw_mixed, "batch never mixed 2-stance with 3/4-stance"
    assert calls == {"batched_inverse": 4, "batched_inverse_small": 4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_r", [64, 66, 32])
def test_k3_kernel_matches_plain_on_card(card, n_r):
    """The live blocks at 64 and 66 variables; at 32 the leading 32 x 32
    block of the SPD KKT matrices, the first base of the Schur recursion
    (K6a)."""
    m_b, live = _eliminated_kkt_batch([TROT_A, TROT_B, EARLY, STAND] * 4,
                                      card)
    m = (m_b[:, :n_r, :n_r].contiguous() if n_r == 32
         else _live_blocks(m_b, live, n_r))
    before = kernels.launches["batched_inverse_small"]
    x = kernels.batched_inverse_small(m)
    torch.cuda.synchronize()
    assert kernels.launches["batched_inverse_small"] == before + 1
    assert torch.equal(x, kernels.batched_inverse_small_plain(m))
