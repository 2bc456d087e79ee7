"""Component timing of the batched MPC tick on the card (counterpart of
``scripts/profile_batched.py``, with the inverse list of
``scripts/profile_inverse.py``), so it shows where the next kernel
belongs:

    python -m a1_qp_mpc_controller_tpu_torch.runtime.components --batch 1024

On ``gazebo_mpc`` in fixed mode at ``--iters`` ADMM iterations, from a
trotting batch (``make_flat_batch`` from seed 0, then 40 standing and 40
trotting ticks on the 'gj' route), it times one row each:

- ``control_tick`` over the batch (its own solve, ``torch.linalg.inv``
  inside);
- the build (``control_tick_build`` with the per-scenario A and the
  scaling lookup);
- the scaled KKT assembly, per scenario and on the shared basis;
- every KKT inverse on the same batch of per-scenario KKT matrices:
  ``torch.linalg.inv``, K1, K6b, K6c, K6d at rank 2 and 4, K6e at rank 4
  and 8, K6f, K6g and the batch-last sweep (K6j), each with
  ||MX - I||_max;
- ``admm_solve_fixed`` with the inverse given, K4 and K2 (through
  ``admm_solve_fixed_batched[_shared]``) on the same inverse;
- the full batched tick on 'xla' and on 'pallas_shared'.

Each time is :func:`runtime.profiling.time_scan`'s best per call. The
script needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from a1_qp_mpc_controller_tpu_torch.config import load_profile
from a1_qp_mpc_controller_tpu_torch.control import grf
from a1_qp_mpc_controller_tpu_torch.control.controller import (
    control_tick, control_tick_build,
)
from a1_qp_mpc_controller_tpu_torch.models import srb
from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops import kernels_retired as retired
from a1_qp_mpc_controller_tpu_torch.ops import qp as qpx
from a1_qp_mpc_controller_tpu_torch.parallel import batched
from a1_qp_mpc_controller_tpu_torch.runtime.profiling import time_scan
from a1_qp_mpc_controller_tpu_torch.sim import plant
from a1_qp_mpc_controller_tpu_torch.types import JoyCmd

STAND_TICKS = 40
WALK_TICKS = 40
SEED = 0

# (row name, the inverse as a function of the (B, n, n) KKT batch)
INVERSES = (
    ("torch.linalg.inv", torch.linalg.inv),
    ("K1 batched_inverse", kernels.batched_inverse),
    ("K6b batched_inverse_inplace", retired.batched_inverse_inplace),
    ("K6c batched_inverse_combined", retired.batched_inverse_combined),
    ("K6d batched_inverse_rank r=2",
     lambda m: retired.batched_inverse_rank(m, rank=2)),
    ("K6d batched_inverse_rank r=4",
     lambda m: retired.batched_inverse_rank(m, rank=4)),
    ("K6e batched_inverse_rank_masked r=4",
     lambda m: retired.batched_inverse_rank_masked(m, rank=4)),
    ("K6e batched_inverse_rank_masked r=8",
     lambda m: retired.batched_inverse_rank_masked(m, rank=8)),
    ("K6f batched_inverse_spd", retired.batched_inverse_spd),
    ("K6g batched_inverse_T", retired.batched_inverse_T),
    ("K6j batched_inverse_sweep_T_masked",
     retired.batched_inverse_sweep_T_masked),
)


def resid_max(m: torch.Tensor, x: torch.Tensor) -> float:
    """||M X - I||_max over the batch, in float64."""
    eye = torch.eye(m.shape[-1], dtype=torch.float64, device=m.device)
    return float((m.double() @ x.double() - eye).abs().max())


def components(cfg, params_b, cs, mem, sensors, joy: JoyCmd, dt, *,
               iters: int = 50, repeats: int = 5, reps: int = 3,
               printer=print) -> list[dict]:
    """Time each component on one batch of tick inputs; returns the rows
    ({"name", "ms"} and, for an inverse, "resid"), each printed as it is
    measured."""
    cfg = dataclasses.replace(cfg, mpc_qp_iters=iters,
                              mpc_solver_mode="fixed")
    settings = qpx.QPSettings(rho=grf._MPC_RHO0, adaptive_rho=False)
    dtype, device = cs.root_pos.dtype, cs.root_pos.device
    rows = []

    def row(name, fn, **extra):
        ms = time_scan(lambda c: fn(), None, repeats=repeats,
                       reps=reps) * 1e3
        rows.append(dict(name=name, ms=ms, **extra))
        printer(f"{name:44s} {ms:9.3f} ms"
                + "".join(f"  {k} {v:.3e}" for k, v in extra.items()))

    def build():
        cs2, mem2, prob = control_tick_build(cfg, params_b, cs, mem, sensors,
                                             joy, dt, with_a_mat=True)
        return prob, qpx.rescale_cost(
            prob.p_mat, prob.q_vec,
            grf.scaling_for_contacts(mem2.mpc_scaling_table, cs2.contacts))

    row(f"control_tick (fixed, {iters} it)",
        lambda: control_tick(cfg, params_b, cs, mem, sensors, joy, dt))
    row("build (ingest..cost+bounds, scaling)", build)
    prob, scal = build()
    a0, a1 = srb.friction_constraint_basis(cfg.horizon, dtype, device)
    mu = params_b.mu_mpc
    dense_kkt = lambda: qpx.scaled_kkt_matrix(
        prob.p_mat, prob.q_vec, prob.a_mat, prob.lb, prob.ub, settings,
        prob.rho0, scal)
    row("scaled KKT (per scenario)", dense_kkt)
    row("scaled KKT (shared basis)", lambda: qpx.scaled_kkt_matrix_shared(
        prob.p_mat, a0, a1, mu, prob.lb, prob.ub, settings, prob.rho0, scal))
    m_b = dense_kkt()
    for name, inverse in INVERSES:
        row(f"KKT inverse: {name}", lambda: inverse(m_b),
            resid=resid_max(m_b, inverse(m_b)))
    minv = torch.linalg.inv(m_b).contiguous()    # column-major on a card
    row(f"admm_solve_fixed {iters} it (inverse given)",
        lambda: qpx.admm_solve_fixed(
            prob.p_mat, prob.q_vec, prob.a_mat, prob.lb, prob.ub, iters,
            settings, x0=prob.warm_x, y0=prob.warm_y, rho0=prob.rho0,
            scaling=scal, kkt_inv=minv))
    row(f"K4 fused ADMM {iters} it", lambda: qpx.admm_solve_fixed_batched(
        prob.p_mat, prob.q_vec, prob.a_mat, prob.lb, prob.ub, iters,
        settings, prob.warm_x, prob.warm_y, prob.rho0, scal, minv))
    row(f"K2 fused ADMM shared {iters} it",
        lambda: qpx.admm_solve_fixed_batched_shared(
            prob.p_mat, prob.q_vec, a0, a1, mu, prob.lb, prob.ub, iters,
            settings, prob.warm_x, prob.warm_y, prob.rho0, scal, minv))
    for backend in ("xla", "pallas_shared"):
        row(f"batched tick '{backend}'", lambda: batched.batched_control_tick(
            cfg, params_b, cs, mem, sensors, joy, dt, admm_backend=backend))
    return rows


def trotting_batch(batch: int, device="cuda"):
    """``gazebo_mpc`` scenarios from ``make_flat_batch`` (randomized from
    ``SEED``), stood up for ``STAND_TICKS`` and trotting at 0.3 m/s for
    ``WALK_TICKS`` ticks on the 'gj' route; returns (cfg, params, tick
    inputs: cs, mem, sensors, joy, dt)."""
    cfg, params = load_profile("gazebo_mpc", device=device)
    cfg = dataclasses.replace(cfg, mpc_solver_mode="fixed", mpc_qp_iters=25)
    gen = torch.Generator().manual_seed(SEED)
    pb, terr, carry = batched.make_flat_batch(cfg, gen, batch, params,
                                              device=device)
    joy_s = JoyCmd.zeros(device=device)
    joy_w = joy_s.replace(
        ctrl_state=torch.ones((), dtype=torch.int32, device=device),
        velx=torch.full((), 0.3, device=device))
    for t in range(STAND_TICKS + WALK_TICKS):
        carry = batched.batched_closed_loop_step(
            cfg, pb, terr, carry, joy_s if t < STAND_TICKS else joy_w,
            cfg.control_dt, device=device, admm_backend="pallas_shared",
            kkt_backend="gj")
    dt = torch.full((), cfg.control_dt, device=device)
    sensors = plant.read_sensors(pb, carry.ps, carry.prev_root_lin_vel, dt)
    return cfg, pb, (carry.cs, carry.mem, sensors, joy_w, dt)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("components: no CUDA device", file=sys.stderr)
        return 1
    cfg, pb, tick = trotting_batch(args.batch)
    print(f"batch={args.batch} iters={args.iters} "
          f"device={torch.cuda.get_device_name(0)}")
    rows = components(cfg, pb, *tick, iters=args.iters)
    print(json.dumps({"components": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
