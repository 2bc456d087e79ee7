"""The port's terrain evaluation against the JAX package
(``sim/terrain.py``, ``parallel/batched.py`` ``randomize_terrain``,
``make_batch``, ``batched_step``, ``batched_rollout``):

- ``Terrain.slope`` / ``Terrain.stairs`` (the JAX defaults) and
  ``randomize_terrain``'s draws: ``height`` against the JAX ``height`` on
  a grid of points across the slope's foot and every riser, within 1e-6
  m (float32 ``tan`` and ``floor`` on the same inputs);
- ``randomize_terrain``: the three kinds and their fixed fields, from an
  explicit generator, on the device asked for;
- one ``batched_step`` at B = 4 with 2 plant substeps from the JAX
  ``make_batch``'s draw (flat, sloped and stepped scenarios) carried
  across by ``convert``, against the JAX ``batched_step``: root position
  within 1e-5 m and torques within 1e-4 N m, the limits of
  ``tests/test_parallel.py``'s batched-against-single test, from the
  draw as it is (inside the 10-tick torque warm-up, which holds the
  torques at 0); then with the
  warm-up passed, the MPC's torques within 5e-3 N m (two ADMM codes of
  25 float32 iterations that sum in other orders part by ~3e-3 N m on
  this tick; the limit of ``torch_parity.trot_ticks_match``);
- ``batched_rollout``: 20 standing steps from the same draw against the
  JAX ``batched_rollout``: finite, alive 1.0 on both, each step's height
  error within 1e-4 m of the JAX one and the metrics within 1e-4 m (the
  plant integrates float32 forces of two ADMM codes that sum in other
  orders; they part by up to 1e-5 m over the 20 steps, on the slope).

The JAX references run under ``jax.jit``. The port's counterpart of
``tests/test_golden.py``'s slope gate (``run_gate`` on
``Terrain.slope(0.15)``, 2 s) runs under ``slow``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from a1_qp_mpc_controller_tpu.config import load_profile as jload
from a1_qp_mpc_controller_tpu.parallel import batched as jbatched
from a1_qp_mpc_controller_tpu.sim import closed_loop as jcl
from a1_qp_mpc_controller_tpu.sim import terrain as jterrain
from a1_qp_mpc_controller_tpu.types import JoyCmd as JJoy
from a1_qp_mpc_controller_tpu_torch.config import RobotParams, load_profile
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tbatched
from a1_qp_mpc_controller_tpu_torch.runtime import golden
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as tcl
from a1_qp_mpc_controller_tpu_torch.sim import terrain as tterrain
from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

from torch_parity import CPU, assert_close, to_port

B, SUBSTEPS, ROLLOUT_STEPS = 4, 2, 20
SCHEDULE = dict(mpc_qp_iters=25, mpc_solver_mode="fixed")   # bench.py's
HEIGHT_TOL = 1e-6      # m
ROOT_POS_TOL = 1e-5    # m, tests/test_parallel.py
TORQUE_TOL = 1e-4      # N m, tests/test_parallel.py
MPC_TORQUE_TOL = 5e-3  # N m, past the warm-up: torch_parity's trot limit
ROLLOUT_TOL = 1e-4     # m


def _xs(n=241):
    """Points from behind the slope's and the stairs' start to past the
    last riser, each riser edge among them."""
    return np.linspace(-0.5, 3.5, n, dtype=np.float32)


@pytest.mark.parametrize("kind", ["slope", "stairs", "random"])
def test_height_matches_jax(kind):
    b = 3
    if kind == "slope":
        pitches = (0.15, -0.2, 0.05)
        jts = [jterrain.Terrain.slope(p) for p in pitches]
        tt = tterrain.Terrain.slope(b, 0.15, device=CPU)
        tt = tt.replace(pitch=torch.tensor(pitches))
    elif kind == "stairs":
        jts = [jterrain.Terrain.stairs()] * b
        tt = tterrain.Terrain.stairs(b, device=CPU)
    else:
        tt = tbatched.randomize_terrain(torch.Generator().manual_seed(2), b,
                                        device=CPU)
        jts = [jterrain.Terrain(**{
            f.name: jnp.asarray(getattr(tt, f.name)[i].numpy())
            for f in dataclasses.fields(tt)}) for i in range(b)]
    x = _xs()
    y = np.full_like(x, 0.1)
    got = tterrain.height(tt, torch.tensor(x).expand(b, -1),
                          torch.tensor(y).expand(b, -1)).numpy()
    want = np.stack([np.asarray(jax.jit(jterrain.height)(jt, x, y))
                     for jt in jts])
    np.testing.assert_allclose(got, want, atol=HEIGHT_TOL)
    assert np.ptp(want) > 0.05


def test_randomize_terrain_kinds():
    g = torch.Generator().manual_seed(0)
    tt = tbatched.randomize_terrain(g, 300, device=CPU)
    flat = (tt.pitch == 0) & (tt.step_height == 0)
    slope, stairs = tt.pitch != 0, tt.step_height != 0
    assert not (slope & stairs).any()
    for m in (flat, slope, stairs):
        assert 60 < int(m.sum()) < 140
    assert (tt.pitch.abs() <= 0.2).all()
    assert torch.equal(tt.step_height[stairs], torch.full_like(
        tt.step_height[stairs], 0.06))
    for field, v in dict(slope_start=0.4, slope_len=8.0, step_len=0.3,
                         stairs_start=0.5, n_steps=6.0).items():
        assert (getattr(tt, field) == v).all(), field
    again = tbatched.randomize_terrain(torch.Generator().manual_seed(0),
                                       300, device=CPU)
    assert torch.equal(again.pitch, tt.pitch)


@pytest.fixture(scope="module")
def start():
    """The JAX ``make_batch`` draw (B = 4: PRNGKey(2) gives two flat
    scenarios, a slope and a staircase) and the port's copy of it."""
    cfg, params = jload("gazebo_mpc")
    cfg = dataclasses.replace(cfg, **SCHEDULE)
    tcfg, _ = load_profile("gazebo_mpc", device=CPU)
    tcfg = dataclasses.replace(tcfg, **SCHEDULE)
    pb, terr, carry = jax.jit(lambda key: jbatched.make_batch(
        cfg, key, B, params))(jax.random.PRNGKey(2))
    kinds = set(1 * (np.asarray(terr.pitch) != 0)
                + 2 * (np.asarray(terr.step_height) != 0))
    assert kinds == {0, 1, 2}, kinds
    return dict(cfg=cfg, pb=pb, terr=terr, carry=carry, tcfg=tcfg,
                tpb=to_port(RobotParams, pb),
                tterr=to_port(tterrain.Terrain, terr),
                tcarry=to_port(tcl.LoopCarry, carry))


@pytest.mark.parametrize("warmed", [False, True])
def test_batched_step_matches_jax(start, warmed):
    cfg, tcfg = start["cfg"], start["tcfg"]
    carry, tcarry = start["carry"], start["tcarry"]
    if warmed:
        carry = carry.replace(mem=carry.mem.replace(tick=jnp.full(
            (B,), cfg.torque_warmup_ticks, jnp.int32)))
        tcarry = tcarry.replace(mem=tcarry.mem.replace(tick=torch.full(
            (B,), cfg.torque_warmup_ticks, dtype=torch.int32)))
    dt = jnp.float32(cfg.control_dt)
    jc, jerr = jbatched.batched_step(cfg, start["pb"], start["terr"], carry,
                                     JJoy.zeros(), dt, substeps=SUBSTEPS)
    tc, terr_ = tbatched.batched_step(
        tcfg, start["tpb"], start["tterr"], tcarry, JoyCmd.zeros(device=CPU),
        tcfg.control_dt, substeps=SUBSTEPS, device=CPU)
    assert_close(tc.ps.root_pos, jc.ps.root_pos, atol=ROOT_POS_TOL)
    assert_close(tc.cs.joint_torques, jc.cs.joint_torques,
                 atol=MPC_TORQUE_TOL if warmed else TORQUE_TOL)
    assert_close(terr_, jerr, atol=ROOT_POS_TOL)
    assert (np.abs(np.asarray(jc.cs.joint_torques)).max() > 1.0) == warmed


def test_batched_rollout_matches_jax(start):
    cfg, tcfg = start["cfg"], start["tcfg"]
    n = ROLLOUT_STEPS
    jc, jerrs, jm = jbatched.batched_rollout(
        cfg, start["pb"], start["terr"], start["carry"], jcl.joy_schedule(n),
        n)
    tc, terrs, tm = tbatched.batched_rollout(
        tcfg, start["tpb"], start["tterr"], start["tcarry"],
        tcl.joy_schedule(n, device=CPU), n, device=CPU)
    assert terrs.shape == (n, B)
    assert torch.isfinite(terrs).all() and torch.isfinite(tc.ps.root_pos).all()
    assert float(tm["alive_frac"]) == float(jm["alive_frac"]) == 1.0
    assert_close(terrs, jerrs, atol=ROLLOUT_TOL)
    for key in ("mean_height_err", "p95_height_err"):
        assert_close(tm[key], jm[key], atol=ROLLOUT_TOL, err_msg=key)


@pytest.mark.slow
def test_slope_gate_fixed_mode():
    """``tests/test_golden.py``'s slope protocol on the port: the fixed
    lock-step solver (50 iterations) on a 0.15 rad slope, 2 s, every
    41st tick from the walk onset, at the JAX test's limits."""
    with threadpool_limits(1):
        rep = golden.run_gate(
            seconds=2.0, sample_every=41, verbose=False, solver_mode="fixed",
            mpc_iters=50, terrain=tterrain.Terrain.slope(1, 0.15, device=CPU),
            device=CPU)
    assert not rep["nan"]
    assert rep["frac_within_tol"] >= 0.9
    assert rep["p95_dev_N"] < 10.0
