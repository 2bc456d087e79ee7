"""Golden-trajectory gates: force trajectories against the float64
reference solver along a closed-loop trot (counterpart of
``runtime/golden.py`` and of the gate in
``scripts/run_golden_amortized.py``).

The port's control stack runs closed-loop in float32. At sampled ticks
each scenario's QP is rebuilt from the controller state on its own path
(``rebuild_mpc_qp``: the reference's equality-pin form, not the swing
elimination that the controller solves; ``rebuild_stand_qp``) and solved
in float64 by the NumPy reference solver (``ops/qp_ref``, to 1e-9
residuals). Each sample's deviation is the largest difference over legs
and axes between the controller's world-frame forces and that optimum,
and the gate reports the share within tolerance. A strictly convex QP
has one optimum, so any solver converged to tight residuals gives the
same forces.

- ``run_gate``: one scenario through ``sim.closed_loop.rollout`` (the
  single-scenario ``control_tick``), on an MPC or a stand-QP profile;
- ``run_stand_batched_gate``: the lock-step batched stand-QP route;
- ``run_amortized_gate``: the batched MPC bench route ('amortized', K1
  and K2) or its 'gj' column, on the 16 randomized draws of
  ``amortized_gate_draws.json``.

The float64 solves run in this process, or with ``workers`` > 1 in a
pool of processes that solve each sample as it comes, beside the
rollout. The record's protocols run from ``scripts.run_golden_dense``
and ``scripts.run_golden_amortized``; the stand gate alone:

    python -m a1_qp_mpc_controller_tpu_torch.runtime.golden --seconds 1.0
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing as mp
import os
import sys
from pathlib import Path

import numpy as np
import torch

from a1_qp_mpc_controller_tpu_torch.config import (
    GRAVITY, A1Config, RobotParams, load_profile,
)
from a1_qp_mpc_controller_tpu_torch.control import grf
from a1_qp_mpc_controller_tpu_torch.models import srb
from a1_qp_mpc_controller_tpu_torch.ops import qp_ref
from a1_qp_mpc_controller_tpu_torch.parallel import batched
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as cl
from a1_qp_mpc_controller_tpu_torch.sim import terrain as terrain_mod
from a1_qp_mpc_controller_tpu_torch.tensors import (
    CUDA, broadcast_batch, const, resolve_device, tree_map,
)
from a1_qp_mpc_controller_tpu_torch.types import CtrlState, JoyCmd

GATE_SEED = 7
GAIT_PERIOD = 240.0       # gait counter ticks of a full cycle
GAIT_SPAN = 110.0         # the batch's phases spread over this many
WALK_AFTER_S = 0.5        # the stand gate's walk onset
WALK_VELX = 0.3           # m/s after the onset
STAND_QP_ITERS = 100      # the first pass's fixed ADMM iterations
TOL_N = 2.0               # a sample is within tolerance below this (N)
REF_EPS = 1e-9            # the float64 optimum's residuals
OSQP_DEFAULT_EPS = 1e-3   # OSQP's default eps_abs = eps_rel

# bench.py build(): the round-5 schedule that the amortized gate runs
BENCH_SCHEDULE = dict(mpc_qp_iters=25, mpc_solver_mode="fixed",
                      mpc_cooldown_ticks=32, mpc_cooldown_stride=4,
                      mpc_cooldown_dense=12, mpc_drift_rescue_n=0.5)
# bench.py's rescue budget and Neumann order, and the reduced tier it
# gives the backends other than 'amortized' and 'full'
RESCUE_ITERS = 150
REFINE_ORDER = 3
REDUCED_NR = 64
GATE_BACKENDS = ("amortized", "gj")
# the randomized RobotParams fields of the record's 16 scenarios: the
# JAX package's make_flat_batch(cfg, PRNGKey(GATE_SEED), 16, params)
# draws, float32 values written exactly
DRAWS_FILE = Path(__file__).with_name("amortized_gate_draws.json")
DRAWN_FIELDS = ("robot_mass", "trunk_inertia", "mu_mpc",
                "gait_counter_speed", "kp_foot")
WORST = 12                # the worst samples a batched gate lists
# a pool's workers solve one small QP each at a time: one BLAS thread
# each, or they oversubscribe the host's cores
BLAS_THREADS_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS")


def staggered_gait(carry: cl.LoopCarry) -> cl.LoopCarry:
    """Gait phases spread over GAIT_SPAN counter ticks across the batch,
    so that contact flips land on different ticks in different
    scenarios (the hard case for a lock-step batch)."""
    gc = carry.cs.gait_counter
    offs = torch.linspace(0.0, GAIT_SPAN, gc.shape[0], dtype=gc.dtype,
                          device=gc.device)[:, None]
    return carry.replace(cs=carry.cs.replace(
        gait_counter=(gc + offs) % GAIT_PERIOD))


def rebuild_mpc_qp(cfg: A1Config, params: RobotParams, cs: CtrlState,
                   dt: torch.Tensor):
    """The MPC QP that each scenario's controller solved this tick, in
    the reference's form (A1RobotControl.cpp:446-518): one discretized
    B_d for the whole horizon, condensed step by step, every force a
    variable and a swing leg's forces pinned to zero by equal bounds.
    The controller solves the swing-eliminated form
    (``grf.mpc_problem``), which has the same optimum. Returns (P, q, A,
    l, u), each with the leading batch axis."""
    b, h = cs.root_pos.shape[0], cfg.horizon
    dtype, dev = cs.root_pos.dtype, cs.root_pos.device
    mpc_states = torch.cat([
        cs.root_euler, cs.root_pos, cs.root_ang_vel, cs.root_lin_vel,
        torch.full((b, 1), -GRAVITY, dtype=dtype, device=dev)], dim=1)
    lin_vel_d_world = torch.einsum("bij,bj->bi", cs.root_rot_mat,
                                   cs.root_lin_vel_d)
    x_ref = srb.build_reference_trajectory(
        cs.root_euler, cs.root_pos, cs.root_pos_d, cs.root_euler_d,
        cs.root_ang_vel_d, lin_vel_d_world, dt, h)
    a_c = srb.continuous_a(cs.root_euler)
    b_c = srb.continuous_b(params.robot_mass, params.trunk_inertia,
                           cs.root_rot_mat, cs.foot_pos_abs)
    _, b_d = srb.discretize(a_c, b_c, dt)
    b_d_list = b_d[:, None].expand((b, h) + b_d.shape[1:])
    a_qp, b_qp = srb.condense(a_c, b_d_list, dt, h)
    p_mat, q_vec = srb.mpc_cost(a_qp, b_qp, params.q_weights,
                                params.r_weights, mpc_states, x_ref, h)
    a_mat = srb.friction_constraint_matrix(params.mu_mpc, h)
    lb, ub = srb.mpc_bounds(cs.contacts, params.fz_min, params.fz_max, h)
    return p_mat, q_vec, a_mat, lb, ub


def rebuild_stand_qp(cfg: A1Config, params: RobotParams, cs: CtrlState):
    """The 12-variable stand QP that each scenario's controller solved
    this tick, with the swing legs' variables eliminated: the port's
    ``grf.stand_qp``, the same arithmetic as the JAX package's
    ``rebuild_stand_qp``. Returns (P, q, A, l, u)."""
    return grf.stand_qp(params, cs)


def _host(*tensors) -> list:
    """Several (B, ...) tensors in one copy to the host, as float64 NumPy
    arrays of the same shapes."""
    flat = torch.cat([t.reshape(t.shape[0], -1).double() for t in tensors],
                     dim=1).cpu().numpy()
    out, k = [], 0
    for t in tensors:
        n = t[0].numel()
        out.append(flat[:, k:k + n].reshape(t.shape))
        k += n
    return out


def _world_forces(cs: CtrlState) -> torch.Tensor:
    """(B, 4, 3) ground-reaction forces in the world frame."""
    return torch.einsum("bij,blj->bli", cs.root_rot_mat.double(),
                        cs.foot_forces_grf.double())


def sample_deviation(qp, f_ours, fidelity: bool = False):
    """One sample against the float64 optimum of its QP (P, q, A, l, u):
    (the largest force deviation, the optimum's largest force and, with
    ``fidelity``, how far the same QP solved at OSQP's default
    tolerances lies from that optimum, else None). N throughout."""
    x64, _, _, _ = qp_ref.solve_qp_ref(*qp, eps=REF_EPS)
    f_ref = x64[:12].reshape(4, 3)
    ref_dev = None
    if fidelity:
        x3, _, _, _ = qp_ref.solve_qp_ref(*qp, eps=OSQP_DEFAULT_EPS)
        ref_dev = float(np.abs(x3[:12].reshape(4, 3) - f_ref).max())
    return (float(np.abs(f_ours - f_ref).max()), float(np.abs(f_ref).max()),
            ref_dev)


class Solves:
    """The float64 solves of a gate's samples: in this process with
    ``workers`` <= 1, else in a pool of ``workers`` processes, each
    sample handed over as it comes so that the solves run beside the
    rollout. A context manager: leaving it ends the pool."""

    def __init__(self, workers: int = 1):
        self.pool = None
        self.results = []
        if workers > 1:
            saved = {k: os.environ.get(k) for k in BLAS_THREADS_ENV}
            os.environ.update(dict.fromkeys(BLAS_THREADS_ENV, "1"))
            try:
                self.pool = mp.get_context("spawn").Pool(workers)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k)
                    else:
                        os.environ[k] = v

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()

    def add(self, qp, f_ours, fidelity: bool = False):
        args = (qp, f_ours, fidelity)
        self.results.append(
            self.pool.apply_async(sample_deviation, args)
            if self.pool is not None else sample_deviation(*args))

    def collect(self) -> list:
        return [r.get() if self.pool is not None else r
                for r in self.results]


def _dev_report(devs: np.ndarray, tol: float) -> dict:
    """The deviations' summary; a run without a sample (shorter than its
    walk onset) fails its gate: no share within ``tol``."""
    if not len(devs):
        nan = float("nan")
        return {"samples": 0, "max_dev_N": nan, "mean_dev_N": nan,
                "p95_dev_N": nan, "frac_within_tol": 0.0, "tol_N": tol}
    return {
        "samples": int(len(devs)),
        "max_dev_N": float(devs.max()),
        "mean_dev_N": float(devs.mean()),
        "p95_dev_N": float(np.percentile(devs, 95)),
        "frac_within_tol": float((devs <= tol).mean()),
        "tol_N": tol,
    }


def run_gate(seconds: float = 10.0, sample_every: int = 50,
             walk_after_s: float = 1.0, velx: float = 0.3,
             mpc_iters: int = 400, solver_mode: str = "adaptive",
             profile: str = "gazebo_mpc",
             terrain: terrain_mod.Terrain | None = None,
             tol_newton: float = 2.0, verbose: bool = True,
             rescue_iters: int = 0, cooldown_ticks: int = 4,
             cooldown_stride: int = 1, cooldown_dense: int = 4,
             drift_rescue_n: float = 0.0,
             ref_fidelity_baseline: bool = False, workers: int = 1,
             device=CUDA) -> dict:
    """The JAX package's single-scenario protocol: ``profile`` with the
    solver knobs given, one scenario standing (``make_standing_start``)
    on ``terrain`` (flat by default; a batch of one), standing until
    ``walk_after_s`` and then walking at ``velx``; from the walk onset
    every ``sample_every``-th tick, the forces against the float64
    optimum of the tick's QP, rebuilt. ``ref_fidelity_baseline`` adds
    the ``ref_osqp_default_*`` columns: how far the same QPs solved at
    OSQP's default tolerances (the reference's settings) lie from the
    optimum."""
    device = resolve_device(device)
    cfg, params = load_profile(profile, device=device)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=mpc_iters,
                              mpc_solver_mode=solver_mode,
                              mpc_rescue_iters=rescue_iters,
                              mpc_cooldown_ticks=cooldown_ticks,
                              mpc_cooldown_stride=cooldown_stride,
                              mpc_cooldown_dense=cooldown_dense,
                              mpc_drift_rescue_n=drift_rescue_n)
    params = broadcast_batch(params, 1)
    if terrain is None:
        terrain = terrain_mod.Terrain.flat(1, device=device)
    n_steps = int(seconds / cfg.control_dt)
    walk_after = int(walk_after_s / cfg.control_dt)
    joy = cl.joy_schedule(n_steps, walk_after=walk_after, velx=velx,
                          device=device)
    carry = cl.make_standing_start(cfg, params, terrain, device=device)
    dt = const(cfg.control_dt, torch.float32, device)
    stand = cfg.stance_leg_control_type == 0

    times = []
    with Solves(workers) as solves:
        for t in range(n_steps):
            carry, _ = cl.rollout(cfg, params, terrain, carry,
                                  tree_map(lambda a: a[t:t + 1], joy), 1,
                                  device=device)
            if t < walk_after or (t - walk_after) % sample_every:
                continue
            qp = (rebuild_stand_qp(cfg, params, carry.cs) if stand
                  else rebuild_mpc_qp(cfg, params, carry.cs, dt))
            *qp, f_ours = _host(*qp, _world_forces(carry.cs))
            solves.add([v[0] for v in qp], f_ours[0], ref_fidelity_baseline)
            times.append(t * cfg.control_dt)
        results = solves.collect()
    devs = np.array([r[0] for r in results])
    if verbose:
        for k in range(0, len(results), 10):
            print(f"  t={times[k]:.2f}s dev={devs[k]:.3f} N (ref max "
                  f"{results[k][1]:.0f} N)", file=sys.stderr)
    root = carry.ps.root_pos[0].cpu()
    report = dict(_dev_report(devs, tol_newton),
                  final_x_m=float(root[0]), final_z_m=float(root[2]),
                  nan=bool(torch.isnan(root).any()))
    if ref_fidelity_baseline:
        rd = np.array([r[2] for r in results])
        report["ref_osqp_default_max_dev_N"] = float(rd.max())
        report["ref_osqp_default_p95_dev_N"] = float(np.percentile(rd, 95))
        report["ref_osqp_default_frac_within_tol"] = float(
            (rd <= tol_newton).mean())
    return report


def run_stand_batched_gate(seconds: float = 1.5, sample_every: int = 2,
                           batch: int = 3, device=CUDA) -> dict:
    """The JAX package's protocol: ``gazebo_qp`` in fixed mode,
    ``make_flat_batch`` from seed 7, gait phases staggered over
    GAIT_SPAN ticks, standing until ``WALK_AFTER_S`` and then walking at
    ``WALK_VELX``; from the walk onset every ``sample_every``-th tick,
    every scenario's forces against the float64 optimum of its QP
    (``grf.stand_qp``, the QPs ``compute_grf`` solved that tick). The
    rescue holds the whole batch, as the walk onset flips every
    scenario on the same tick."""
    device = resolve_device(device)
    cfg, params = load_profile("gazebo_qp", device=device)
    cfg = dataclasses.replace(cfg, mpc_solver_mode="fixed",
                              stand_qp_iters=STAND_QP_ITERS)
    n_steps = int(seconds / cfg.control_dt)
    walk_after = int(WALK_AFTER_S / cfg.control_dt)
    joy = cl.joy_schedule(n_steps, walk_after=walk_after, velx=WALK_VELX,
                          device=device)
    pb, terr, carry = batched.make_flat_batch(
        cfg, torch.Generator().manual_seed(GATE_SEED), batch, params,
        device=device)
    carry = staggered_gait(carry)
    dt = torch.full((), cfg.control_dt, device=device)

    devs = []
    for t in range(n_steps):
        carry = batched.batched_stand_closed_loop_step(
            cfg, pb, terr, carry, tree_map(lambda a: a[t], joy), dt,
            device=device, rescue_capacity=batch)
        if t < walk_after or (t - walk_after) % sample_every:
            continue
        qps = [v.double().cpu().numpy() for v in grf.stand_qp(pb, carry.cs)]
        rot = carry.cs.root_rot_mat.double().cpu().numpy()
        forces = carry.cs.foot_forces_grf.double().cpu().numpy()
        for i in range(batch):
            x64, _, _, _ = qp_ref.solve_qp_ref(*(v[i] for v in qps),
                                               eps=REF_EPS)
            devs.append(float(np.abs(rot[i] @ forces[i].T
                                     - x64.reshape(4, 3).T).max()))
    return dict(_dev_report(np.array(devs), TOL_N),
                nan=bool(torch.isnan(carry.ps.root_pos).any()))


def gate_params(base: RobotParams, n: int, device=CUDA) -> RobotParams:
    """The first ``n`` of the amortized gate's 16 randomized scenarios:
    ``base`` tiled, its DRAWN_FIELDS from DRAWS_FILE."""
    device = resolve_device(device)
    draws = json.loads(DRAWS_FILE.read_text())
    if not 0 < n <= len(draws["mu_mpc"]):
        raise ValueError(f"the gate's draws hold {len(draws['mu_mpc'])} "
                         f"scenarios, not {n}")
    tiled = broadcast_batch(base, n)
    return tiled.replace(**{
        f: torch.tensor(draws[f][:n], dtype=base.robot_mass.dtype,
                        device=device)
        for f in DRAWN_FIELDS})


def gate_tick_kwargs(backend: str, batch: int) -> dict:
    """``bench.py``'s tick arguments for ``backend``, with the capacities
    scaled to the batch as ``scripts/run_golden_amortized.py`` scales
    them: a rescue pool of max(2, B / 4) at 150 iterations, and on
    'amortized' a refresh capacity of max(1, B / 8) at Neumann order 3
    (ages up to B - 1, staler than the bench's); 'gj' gets the reduced
    tier's arguments that ``bench.py`` gives every other backend, which
    its route ignores."""
    if backend not in GATE_BACKENDS:
        raise ValueError(f"unknown gate backend {backend!r}; known: "
                         + ", ".join(map(repr, GATE_BACKENDS)))
    kw = dict(admm_backend="pallas_shared", kkt_backend=backend,
              rescue_capacity=max(2, batch // 4), rescue_iters=RESCUE_ITERS)
    if backend == "amortized":
        kw.update(kkt_amortize_capacity=max(1, batch // 8),
                  kkt_refine_order=REFINE_ORDER)
    else:
        kw.update(kkt_reduced_nr=REDUCED_NR,
                  kkt_big_capacity=max(2, batch // 4))
    return kw


@dataclasses.dataclass
class AmortizedGate:
    """The fixed parts of the amortized gate's rollout (``gate_start``);
    ``tick`` runs one tick of it."""

    cfg: A1Config
    pb: RobotParams
    terr: terrain_mod.Terrain
    joy: JoyCmd               # with a leading time axis
    dt: torch.Tensor
    kw: dict                  # the route's tick arguments
    walk_after: int           # the tick of the walk onset
    n_steps: int
    device: torch.device

    def tick(self, carry: cl.LoopCarry, kc: batched.KktCarry, t: int):
        """Tick ``t`` of the batch: returns (carry, kc, stats) after it;
        ``kc`` only moves on the 'amortized' route."""
        amortized = self.kw["kkt_backend"] == "amortized"
        out = batched.batched_closed_loop_step(
            self.cfg, self.pb, self.terr, carry,
            tree_map(lambda a: a[t], self.joy), self.dt, device=self.device,
            return_stats=True,
            **(dict(self.kw, kkt_carry=kc) if amortized else self.kw))
        return out[0], (out[1] if amortized else kc), out[-1]


def gate_start(seconds: float = 2.5, batch: int = 16,
               walk_after_s: float = 1.0, backend: str = "amortized",
               device=CUDA):
    """The amortized gate's batch before its first tick: ``gazebo_mpc``
    with the bench schedule (``BENCH_SCHEDULE``) on the batched route
    ``backend`` (``gate_tick_kwargs``), ``batch`` randomized scenarios
    (``gate_params``) with gait phases staggered over GAIT_SPAN ticks,
    standing until ``walk_after_s`` and then walking at ``WALK_VELX``.
    Returns (AmortizedGate, carry, kkt carry)."""
    device = resolve_device(device)
    cfg, params = load_profile("gazebo_mpc", device=device)
    cfg = dataclasses.replace(cfg, **BENCH_SCHEDULE)
    pb, terr, carry = batched.flat_batch_from_params(
        cfg, gate_params(params, batch, device), device=device)
    n_steps = int(seconds / cfg.control_dt)
    walk_after = int(walk_after_s / cfg.control_dt)
    gate = AmortizedGate(
        cfg=cfg, pb=pb, terr=terr,
        joy=cl.joy_schedule(n_steps, walk_after=walk_after, velx=WALK_VELX,
                            device=device),
        dt=const(cfg.control_dt, torch.float32, device),
        kw=gate_tick_kwargs(backend, batch), walk_after=walk_after,
        n_steps=n_steps, device=device)
    return (gate, staggered_gait(carry),
            batched.make_kkt_carry(cfg, batch, device=device))


def run_amortized_gate(seconds: float = 2.5, batch: int = 16,
                       sample_every: int = 3, walk_after_s: float = 1.0,
                       backend: str = "amortized",
                       workers: int = 1, verbose: bool = False,
                       detail_path: str | None = None,
                       device=CUDA) -> dict:
    """``scripts/run_golden_amortized.py``'s protocol (``gate_start``):
    from the walk onset every ``sample_every``-th tick, every
    scenario's forces against the float64 optimum of its rebuilt QP.
    Reports the record's keys, ``alive_frac`` and the worst samples
    with their tick, scenario, ticks since its last contact flip, KKT
    age and converged flag; ``detail_path`` saves every sample's."""
    gate, carry, kc = gate_start(seconds, batch, walk_after_s, backend,
                                 device)
    meta = []     # (t, scenario, since_flip, age, converged)
    prev_contacts = carry.cs.contacts.cpu().numpy()
    since_flip = np.full(batch, 10_000, np.int64)
    with Solves(workers) as solves:
        for t in range(gate.n_steps):
            carry, kc, stats = gate.tick(carry, kc, t)
            contacts = carry.cs.contacts.cpu().numpy()
            flipped = (contacts != prev_contacts).any(axis=1)
            since_flip = np.where(flipped, 0, since_flip + 1)
            prev_contacts = contacts
            if verbose and t % 200 == 0:
                print(f"  t={t}/{gate.n_steps}", file=sys.stderr,
                      flush=True)
            if t < gate.walk_after or (t - gate.walk_after) % sample_every:
                continue
            *qp, f_ours, age, conv = _host(
                *rebuild_mpc_qp(gate.cfg, gate.pb, carry.cs, gate.dt),
                _world_forces(carry.cs), kc.age, stats["converged"])
            for i in range(batch):
                meta.append((t, i, int(since_flip[i]), int(age[i]),
                             int(conv[i])))
                solves.add([v[i] for v in qp], f_ours[i])
        devs = np.array([r[0] for r in solves.collect()])
    meta = np.array(meta, dtype=np.int64)
    if detail_path is not None:
        np.savez(detail_path, meta=meta, devs=devs)
    z = carry.ps.root_pos[:, 2]
    worst = [dict(dev_N=float(devs[k]), t=int(meta[k, 0]),
                  scenario=int(meta[k, 1]), since_flip=int(meta[k, 2]),
                  age=int(meta[k, 3]), converged=bool(meta[k, 4]))
             for k in np.argsort(-devs, kind="stable")[:WORST]]
    return dict(_dev_report(devs, TOL_N), scenarios=batch,
                alive_frac=float((~torch.isnan(z)).float().mean()),
                nan=bool(np.isnan(devs).any()
                         or torch.isnan(carry.ps.root_pos).any()),
                worst=worst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_stand_batched_gate(
        args.seconds, batch=args.batch, device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
