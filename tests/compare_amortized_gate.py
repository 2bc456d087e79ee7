"""Diagnosis of the amortized gate (``runtime.golden.run_amortized_gate``)
against the float32 floor, in seven commands:

- ``capture TICKS``: the gate's rollout (``golden.gate_start``) up to the
  last of the comma-separated ticks, on the card by default, pickling for
  each of them the batch's state before the tick (``carry``,
  ``kkt_carry``) and the controller state after it (``cs``) as NumPy
  trees (``convert.to_numpy``). Imports nothing of JAX.
- ``replay STATES``: for each tick that ``capture`` pickled, every
  scenario's forces after the tick four ways, each against the float64
  optimum of the QP rebuilt from its own state after the tick
  (``golden.rebuild_mpc_qp``, ``qp_ref`` to 1e-9):

  - ``card``: as the card computed them (pickled);
  - ``cpu32``: the port on the CPU from the card's state, float32 (K1's
    and K2's plain versions);
  - ``cpu64``: the port on the CPU from the same state in float64;
  - ``jax``: the JAX package on the CPU from the same state, converted
    (``torch_parity.to_jax``; its Pallas kernels in interpret mode).

  A sample far from the optimum on the card and as far on the JAX
  package's tick from the same state is the schedule's (a fixed
  iteration budget on a hard instance), not the port's; one that the
  float64 tick brings to the optimum is the float32 floor's. It prints
  one row per sample over ``--tol`` newtons on any of the four, then
  one JSON line of totals. CPU only.
- ``jax-gate``: the JAX package's own gate on the CPU, its configuration
  and tick arguments taken from ``bench.py`` as
  ``scripts/run_golden_amortized.py`` takes them (``bench_gate_args``),
  its Pallas kernels in interpret mode (a few minutes): the record's
  statistic from another float32 trajectory.
- ``plain K1[,K2]``: the port's gate at the record's protocol, on the
  card by default, with K1 (``batched_inverse``) and, if named, K2
  (``fused_admm_shared``) replaced by their plain PyTorch versions on
  the route; prints the report and the kernels' launches (0 for the
  replaced ones). K1 is bit-equal to its plain version, so ``plain K1``
  must repeat the gate to the digit; K2 sums in another order, so
  ``plain K1,K2`` is a second trajectory of the same arithmetic.
  ``--walk-after S --seconds T`` moves the walk's onset (the runner's
  options of the same names), for the same comparison on another
  trajectory.
- ``shadow [--kernel K4]``: the gate on the kernels, every shared-basis
  solve also run with K2's plain version on the same operands, the two
  exit tests' verdicts and residuals compared (``shadow_gate``): K2's
  x-update sums in float64 and rounds once, the plain version's is one
  float32 reduction, so the float64 primal residual of K2's iterates
  over the plain version's says which of the two float32 trajectories
  lies nearer the exact one; with ``--kernel K4`` the gate's batch on
  the legacy route instead, each solve also run with K4's plain
  version; on the card by default.
- ``orders``: K2's operands from the gate's rollout on the CPU (standing
  and walking), run through K2's arithmetic variants (``k2_variants``:
  ``tests/test_torch_admm_packing.py``'s ``kernel_model`` with the
  x-update as the float64 sum, Dot2 (``dot2_xt``) or the float32 chain,
  and the elementwise updates w,
  rhs, x, ax, zp, z1 and y1 each contracted into one fused multiply-add
  or rounded separately as the plain version rounds them) and through
  the plain version: each variant's median float64 primal residual over
  the plain version's (``xt_orders``). CPU only, ~6 minutes.
- ``paired [--base plain]``: the gate on the kernels (or on K1 and K2
  plain), each sampled tick also run from the same state on the other
  (``paired_gate``); on the card by default; ``--walk-after S --seconds
  T`` as for ``plain``.

    python tests/compare_amortized_gate.py capture 406,541 \\
        --out build/gate_states.pkl
    JAX_PLATFORMS=cpu python tests/compare_amortized_gate.py replay \\
        build/gate_states.pkl
"""

import argparse
import contextlib
import dataclasses
import json
import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from a1_qp_mpc_controller_tpu_torch import convert  # noqa: E402
from a1_qp_mpc_controller_tpu_torch.config import load_profile  # noqa
from a1_qp_mpc_controller_tpu_torch.ops import kernels, qp_ref  # noqa
from a1_qp_mpc_controller_tpu_torch.ops import qp as qpx  # noqa: E402
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb  # noqa
from a1_qp_mpc_controller_tpu_torch.runtime import golden  # noqa: E402
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as tcl  # noqa
from a1_qp_mpc_controller_tpu_torch.tensors import tree_map  # noqa: E402
from a1_qp_mpc_controller_tpu_torch.types import (  # noqa: E402
    CtrlState, JoyCmd,
)

WAYS = ("card", "cpu32", "cpu64", "jax")
CPU = torch.device("cpu")
# name -> (the module attribute the route calls, its plain version)
PLAIN = {"K1": (tb, "batched_inverse", kernels.batched_inverse_plain),
         "K2": (qpx, "fused_admm_shared", kernels.fused_admm_shared_plain),
         "K4": (qpx, "fused_admm", kernels.fused_admm_plain)}
# the legacy route (K1 and K4, per-scenario A, no rescue) as chip_smoke.py
# drives it; its kkt_backend only tells the gate's tick that no KKT carry
# moves
LEGACY_KW = dict(admm_backend="pallas", use_pallas=True, kkt_backend="gj")


def bench_gate_args(backend: str, batch: int):
    """The JAX gate's configuration, params and tick arguments as
    ``scripts/run_golden_amortized.py`` takes them: ``bench.build()``'s
    config and params and ``bench._tick_kwargs(backend)``, the rescue
    pool scaled to max(2, B / 4), the Pallas blocks capped at B and, on
    'amortized', the refresh capacity at max(1, B / 8)."""
    import bench

    cfg, params, *_ = bench.build()
    kw = bench._tick_kwargs(backend)
    kw.update(rescue_capacity=max(2, batch // 4),
              admm_block=min(kw["admm_block"], batch),
              kkt_block=min(kw["kkt_block"], batch))
    if backend == "amortized":
        kw.update(kkt_amortize_capacity=max(1, batch // 8))
    if kw.get("kkt_big_capacity"):
        kw.update(kkt_big_capacity=max(2, batch // 4))
    return cfg, params, kw


def deviations(cfg, pb, cs, dt) -> np.ndarray:
    """(B,) largest force deviation of each scenario from the float64
    optimum of its QP rebuilt from ``cs`` (port tensors)."""
    qp = [v.double().numpy() for v in golden.rebuild_mpc_qp(cfg, pb, cs, dt)]
    forces = golden._world_forces(cs).numpy()
    out = []
    for i in range(forces.shape[0]):
        x64, _, _, _ = qp_ref.solve_qp_ref(*(v[i] for v in qp),
                                           eps=golden.REF_EPS)
        out.append(np.abs(forces[i] - x64[:12].reshape(4, 3)).max())
    return np.array(out)


def to64(tree):
    return tree_map(lambda a: a.double() if a.is_floating_point() else a,
                    tree)


def capture(ticks, path, backend="amortized", batch=16, device="cuda"):
    """Pickle the gate's batch before each tick in ``ticks`` and its
    controller state after it."""
    gate, carry, kc = golden.gate_start(batch=batch, backend=backend,
                                        device=device)
    states = {}
    for t in range(max(ticks) + 1):
        if t in ticks:
            states[t] = dict(carry=convert.to_numpy(carry),
                             kkt_carry=convert.to_numpy(kc))
        carry, kc, _ = gate.tick(carry, kc, t)
        if t in ticks:
            states[t]["cs"] = convert.to_numpy(carry.cs)
    with open(path, "wb") as f:
        pickle.dump(dict(batch=batch, backend=backend,
                         walk_after=gate.walk_after, states=states), f)
    print(json.dumps(dict(ticks=sorted(states), path=str(path))))


@contextlib.contextmanager
def plain_kernels(names):
    """Within the block, the route runs ``names`` (of PLAIN) by their
    plain versions."""
    saved = {name: getattr(PLAIN[name][0], PLAIN[name][1]) for name in names}
    for name in names:
        setattr(PLAIN[name][0], PLAIN[name][1], PLAIN[name][2])
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(PLAIN[name][0], PLAIN[name][1], fn)


def plain_gate(names, workers, device="cuda", seconds=2.5,
               walk_after_s=1.0) -> dict:
    """The gate at the record's protocol (or, with ``walk_after_s``, on
    another trajectory) with ``names`` (of PLAIN) run by their plain
    versions on the route."""
    kernels.reset_launches()
    with plain_kernels(names):
        rep = golden.run_amortized_gate(seconds, walk_after_s=walk_after_s,
                                        workers=workers, device=device)
    rep["launches"] = {PLAIN[n][1]: kernels.launches[PLAIN[n][1]]
                       for n in PLAIN}
    rep["plain"] = list(names)
    return rep


def paired_gate(workers, device="cuda", every=3, base="kernels",
                seconds=2.5, walk_after_s=1.0) -> dict:
    """The gate's rollout on ``base`` ('kernels', or 'plain': K1 and K2
    by their plain versions) and, at each of its samples, the same tick
    again from the same state on the other: each tick's forces against
    the optimum of the QP rebuilt from its own state. The two deviations
    of one sample differ only by the kernels' summation order on that
    tick, so their counts over TOL_N compare the kernels with their
    plain versions at the gate's shapes on its own operands, free of the
    trajectories' drift apart; swapping ``base`` tells a bias of the
    kernels from one of the trajectory the states come from.
    ``seconds`` and ``walk_after_s`` move the walk's onset, as in
    ``plain_gate``."""
    gate, carry, kc = golden.gate_start(seconds, walk_after_s=walk_after_s,
                                        device=device)
    b = carry.cs.contacts.shape[0]
    clone = lambda tree: tree_map(torch.clone, tree)
    on = lambda name: plain_kernels(("K1", "K2") if name == "plain" else ())
    other = "plain" if base == "kernels" else "kernels"
    with golden.Solves(workers) as solves:
        for t in range(gate.n_steps):
            sampled = (t >= gate.walk_after
                       and (t - gate.walk_after) % every == 0)
            before = (clone(carry), clone(kc)) if sampled else None
            with on(base):
                carry, kc, _ = gate.tick(carry, kc, t)
            if not sampled:
                continue
            with on(other):
                alt = gate.tick(*before, t)[0]
            cs = {base: carry.cs, other: alt.cs}
            for name in ("kernels", "plain"):
                *qp, forces = golden._host(
                    *golden.rebuild_mpc_qp(gate.cfg, gate.pb, cs[name],
                                           gate.dt),
                    golden._world_forces(cs[name]))
                for i in range(b):
                    solves.add([v[i] for v in qp], forces[i])
        devs = np.array([r[0] for r in solves.collect()]).reshape(-1, 2, b)
    kern, plain = devs[:, 0].ravel(), devs[:, 1].ravel()
    over_k, over_p = kern > golden.TOL_N, plain > golden.TOL_N
    return dict(base=base,
                kernels=golden._dev_report(kern, golden.TOL_N),
                plain=golden._dev_report(plain, golden.TOL_N),
                over_both=int((over_k & over_p).sum()),
                over_kernels_only=int((over_k & ~over_p).sum()),
                over_plain_only=int((over_p & ~over_k).sum()),
                max_abs_dev_gap_N=float(np.abs(kern - plain).max()),
                mean_dev_gap_N=float((kern - plain).mean()))


def shadow_gate(device="cuda", kernel="K2") -> dict:
    """The gate's rollout on the kernels, every solve through ``kernel``
    also run with its plain version on the same operands. K2: the
    amortized gate, each shared-basis solve
    (``qp.admm_solve_fixed_batched_shared``: K2, then the exit test on
    its output). K4: the gate's batch, stagger and joystick on the legacy
    route (``LEGACY_KW``), each per-scenario-A solve
    (``qp.admm_solve_fixed_batched``: K4, then the exit test). By (B,
    iterations) and before and after the walk onset: how often the exit
    test's verdict differs each way, the median ratio of the kernel's
    residuals to the plain version's (the primal one also recomputed in
    float64 from each solution), and the largest difference of x and z
    over the plain solution's largest entry."""
    gate, carry, kc = golden.gate_start(
        device=device, backend="amortized" if kernel == "K2" else "gj")
    if kernel == "K4":
        gate = dataclasses.replace(gate, kw=LEGACY_KW)
        name, iters_at = "admm_solve_fixed_batched", 5
    else:
        name, iters_at = "admm_solve_fixed_batched_shared", 7
    solve, stats, tick = getattr(qpx, name), {}, [0]

    def prim64(sol, args):
        """||A x - z||_inf of a solution (unscaled), in float64."""
        x = sol.x.double()
        if kernel == "K4":
            ax = torch.einsum("bmn,bn->bm", args[2].double(), x)
        else:
            a0, a1, mu = (a.double() for a in args[2:5])
            ax = x @ a0.T + mu[:, None] * (x @ a1.T)
        return (ax - sol.z.double()).abs().amax(dim=1)

    def shadowed(*args, **kw):
        sol = solve(*args, **kw)
        with plain_kernels((kernel,)):
            ref = solve(*args, **kw)
        key = (f"{sol.x.shape[0]}x{args[iters_at]}",
               "walk" if tick[0] >= gate.walk_after else "stand")
        st = stats.setdefault(key, dict(scenarios=0, conv_kernel_only=0,
                                        conv_plain_only=0, prim=[], dual=[],
                                        prim64=[], x_rel=0.0, z_rel=0.0))
        st["scenarios"] += sol.x.shape[0]
        st["conv_kernel_only"] += int((sol.converged & ~ref.converged).sum())
        st["conv_plain_only"] += int((ref.converged & ~sol.converged).sum())
        st["prim"] += (sol.prim_res / ref.prim_res).tolist()
        st["dual"] += (sol.dual_res / ref.dual_res).tolist()
        st["prim64"] += (prim64(sol, args) / prim64(ref, args)).tolist()
        for name in ("x", "z"):
            a, b = getattr(sol, name), getattr(ref, name)
            st[f"{name}_rel"] = max(st[f"{name}_rel"], float(
                (a - b).abs().max() / b.abs().max()))
        return sol

    setattr(qpx, name, shadowed)
    try:
        for t in range(gate.n_steps):
            tick[0] = t
            carry, kc, _ = gate.tick(carry, kc, t)
    finally:
        setattr(qpx, name, solve)
    for st in stats.values():
        for k in ("prim", "dual", "prim64"):
            v = np.array(st.pop(k))
            st[f"{k}_ratio_median"] = float(np.median(v))
            st[f"{k}_kernel_smaller"] = float((v < 1.0).mean())
    return {f"{shape} {phase}": st
            for (shape, phase), st in sorted(stats.items())}


def dot2_xt(minv, rhs):
    """minv' rhs as a compensated dot product (Dot2 of Ogita, Rump and
    Oishi), one float32 operation for each of an earlier kernel's: in
    ascending row of minv, each product's error exact (the float32
    product's distance from the float64 one, a float32 itself), each
    addition's by TwoSum, the errors summed beside the running sum and
    added once at the end."""
    p = torch.zeros_like(rhs)
    s = torch.zeros_like(rhs)
    for i in range(minv.shape[1]):
        a, b = minv[:, i], rhs[:, i:i + 1]
        h = a * b
        r = (a.double() * b.double() - h.double()).float()
        t = p + h
        z = t - p
        s = s + ((p - (t - z)) + (h - z) + r)
        p = t
    return p + s


def k2_variants() -> dict:
    """K2's arithmetic variants for ``orders``: name -> (the x-update's
    model, the elementwise updates contracted), as
    ``tests/test_torch_admm_packing.py``'s ``kernel_model`` takes them.
    The x-update is the float64 sum rounded once (the kernel's), the
    compensated float32 sum Dot2 (the design before it) or the ascending
    float32 chain (the one before that). Dot2 runs with every update
    contracted (its kernel), every update separate and each update alone
    separate; the float64 sum and the chain with every update separate
    and every update contracted (the chain's kernel)."""
    from test_torch_admm_packing import UPDATES

    out = {"dot2 contracted": ("dot2", UPDATES), "dot2 separate": ("dot2", ())}
    for u in UPDATES:
        out[f"dot2, {u} separate"] = ("dot2",
                                      tuple(v for v in UPDATES if v != u))
    for xt in ("f64", "chain"):
        out[f"{xt} separate"] = (xt, ())
        out[f"{xt} contracted"] = (xt, UPDATES)
    return out


def run_variants(ops, variants) -> dict:
    """Every variant's (x, z) on ``ops`` from one batched run of
    ``kernel_model``: the batch repeated once a variant, each copy's
    x-update by its own model and its switches set by (B, 1) masks."""
    from chip_smoke import f64_xt
    from test_torch_admm_packing import UPDATES, chain_rows, kernel_model

    models = {"f64": f64_xt, "dot2": dot2_xt, "chain": chain_rows}
    names, v, b = list(variants), len(variants), ops["qs"].shape[0]
    rows = lambda pick: torch.tensor(
        [pick(*variants[name]) for name in names]).repeat_interleave(b)[
            :, None]
    big = {k: val if k in ("a0", "a1") or not torch.is_tensor(val)
           else val.repeat((v,) + (1,) * (val.ndim - 1))
           for k, val in ops.items()}
    xt = lambda minv, rhs: torch.cat([
        models[variants[name][0]](minv[i * b:(i + 1) * b],
                                  rhs[i * b:(i + 1) * b])
        for i, name in enumerate(names)])
    x, _, z = kernel_model(
        **big, xt=xt,
        contracted={u: rows(lambda xt, c, u=u: u in c) for u in UPDATES})
    return {name: (x[i * b:(i + 1) * b], z[i * b:(i + 1) * b])
            for i, name in enumerate(names)}


def xt_orders(ticks=560, every=1, calls=24) -> dict:
    """K2's operands from the gate's rollout on the CPU (every
    ``every``-th tick up to ``ticks``; ``calls`` of each (B, iterations)
    before and after the walk onset, spread evenly over what was kept),
    run through each of ``k2_variants`` and through the plain version:
    the median over scenarios of each variant's float64 primal residual
    ||A x - z||_inf over the plain version's, of its own, and of its
    distance from the plain iterations in float64 (over the largest |x|)."""
    gate, carry, kc = golden.gate_start(device=CPU)
    kernel, caps, tick = qpx.fused_admm_shared, {}, [0]

    def keep(**ops):
        key = (f"{ops['qs'].shape[0]}x{ops['iters']}",
               "walk" if tick[0] >= gate.walk_after else "stand")
        if tick[0] % every == 0:
            caps.setdefault(key, []).append(
                {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in ops.items()})
        return kernel(**ops)

    qpx.fused_admm_shared = keep
    try:
        for t in range(ticks):
            tick[0] = t
            carry, kc, _ = gate.tick(carry, kc, t)
    finally:
        qpx.fused_admm_shared = kernel

    def resid(ops, x, z):
        a0, a1 = ops["a0"].double(), ops["a1"].double()
        xd = ops["d"].double() * x.double()
        ax = ops["e"].double() * (xd @ a0.T + ops["mu"].double()[:, None]
                                  * (xd @ a1.T))
        return (ax - z.double()).abs().amax(dim=1)

    variants = k2_variants()
    out = {}
    for key, group in sorted(caps.items()):
        group = [group[i] for i in np.unique(np.linspace(
            0, len(group) - 1, min(calls, len(group))).round().astype(int))]
        base_all, ratio, res, dist = [], *({k: [] for k in variants}
                                          for _ in range(3))
        for ops in group:
            plain = kernels.fused_admm_shared_plain(**ops)
            x64 = kernels.fused_admm_shared_plain(
                **{k: v.double() if torch.is_tensor(v) else v
                   for k, v in ops.items()})[0]
            base = resid(ops, plain[0], plain[2])
            base_all += base.tolist()
            for name, (x, z) in run_variants(ops, variants).items():
                r = resid(ops, x, z)
                ratio[name] += (r / base).tolist()
                res[name] += r.tolist()
                dist[name] += ((x.double() - x64).abs().amax(dim=1)
                               / x64.abs().amax(dim=1)).tolist()
        name = " ".join(key)
        out[name] = dict(
            calls=len(group), resid64_plain_median=float(np.median(base_all)),
            **{v: dict(prim64_ratio_median=float(np.median(ratio[v])),
                       resid64_median=float(np.median(res[v])),
                       dist_to_f64_median=float(np.median(dist[v])))
               for v in variants})
        print(json.dumps({name: out[name]}), flush=True)
    return out


def jax_gate(backend="amortized", batch=16, seconds=2.5, every=3,
             walk_after_s=1.0, workers=4) -> dict:
    """``scripts/run_golden_amortized.py``'s loop on the CPU with the
    Pallas kernels in interpret mode, the record's draws and stagger."""
    import jax
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.parallel import batched as jb
    from a1_qp_mpc_controller_tpu.runtime.golden import rebuild_mpc_qp
    from a1_qp_mpc_controller_tpu.sim import closed_loop as jcl

    cfg, params, kw = bench_gate_args(backend, batch)
    kw = dict(kw, interpret=True, return_stats=True)
    amortized = backend == "amortized"
    pb, terr, carry = jb.make_flat_batch(cfg, jax.random.PRNGKey(7), batch,
                                         params)
    offs = jnp.linspace(0.0, 110.0, batch)[:, None]
    carry = carry.replace(cs=carry.cs.replace(
        gait_counter=(carry.cs.gait_counter + offs) % 240.0))
    n_steps = int(seconds / cfg.control_dt)
    walk_after = int(walk_after_s / cfg.control_dt)
    joy = jcl.joy_schedule(n_steps, walk_after=walk_after, velx=0.3)
    dt = jnp.float32(cfg.control_dt)
    kc = jb.make_kkt_carry(cfg, batch)

    @jax.jit
    def tick(carry, kc, j):
        if amortized:
            return jb.batched_closed_loop_step(cfg, pb, terr, carry, j, dt,
                                               kkt_carry=kc, **kw)
        cr, stats = jb.batched_closed_loop_step(cfg, pb, terr, carry, j,
                                                dt, **kw)
        return cr, kc, stats

    rebuild = jax.jit(jax.vmap(lambda p, c: rebuild_mpc_qp(cfg, p, c, dt)))
    with golden.Solves(workers) as solves:
        for t in range(n_steps):
            carry, kc, _ = tick(carry, kc,
                                jax.tree_util.tree_map(lambda a: a[t], joy))
            if t < walk_after or (t - walk_after) % every:
                continue
            qp = [np.asarray(v, np.float64)
                  for v in rebuild(pb, carry.cs)]
            forces = np.einsum("bij,blj->bli",
                               np.asarray(carry.cs.root_rot_mat, np.float64),
                               np.asarray(carry.cs.foot_forces_grf,
                                          np.float64))
            for i in range(batch):
                solves.add([v[i] for v in qp], forces[i])
        devs = np.array([r[0] for r in solves.collect()])
    alive = float(np.mean(~np.isnan(np.asarray(carry.ps.root_pos[:, 2]))))
    return dict(golden._dev_report(devs, golden.TOL_N), scenarios=batch,
                alive_frac=alive, backend=backend)


def replay(path, tol) -> dict:
    """The four ways of every pickled tick (see the module's docstring)."""
    import jax

    from a1_qp_mpc_controller_tpu.parallel import batched as jb
    from a1_qp_mpc_controller_tpu.types import JoyCmd as JJoy
    from torch_parity import jax_to_dict, to_jax

    with open(path, "rb") as f:
        dump = pickle.load(f)
    b, backend = dump["batch"], dump["backend"]
    kw = golden.gate_tick_kwargs(backend, b)
    amortized = backend == "amortized"

    tcfg, tparams = load_profile("gazebo_mpc", device=CPU)
    tcfg = dataclasses.replace(tcfg, **golden.BENCH_SCHEDULE)
    tpb, tterr, _ = tb.flat_batch_from_params(
        tcfg, golden.gate_params(tparams, b, device=CPU), device=CPU)
    stand = JoyCmd.zeros(device=CPU)
    walk = stand.replace(ctrl_state=torch.ones((), dtype=torch.int32),
                         velx=torch.full((), golden.WALK_VELX))
    dt = torch.full((), tcfg.control_dt)

    cfg, params, jkw = bench_gate_args(backend, b)
    shapes = jax.eval_shape(lambda key: jb.make_flat_batch(
        cfg, key, b, params), jax.random.PRNGKey(0))
    kc_shape = jax.eval_shape(lambda: jb.make_kkt_carry(cfg, b))
    jpb, jterr = to_jax(shapes[0], tpb), to_jax(shapes[1], tterr)
    jstand = JJoy.zeros()
    jwalk = jstand.replace(ctrl_state=np.int32(1),
                           velx=np.float32(golden.WALK_VELX))
    jdt = np.float32(cfg.control_dt)
    jkw = dict(jkw, interpret=True, return_stats=True)
    jstep = jax.jit(lambda c, k, j: jb.batched_closed_loop_step(
        cfg, jpb, jterr, c, j, jdt,
        **(dict(jkw, kkt_carry=k) if amortized else jkw)))

    rows, totals = [], {w: 0 for w in WAYS}
    force_gap = {w: 0.0 for w in WAYS[1:]}
    for t, st in sorted(dump["states"].items()):
        walking = t >= dump["walk_after"]
        joy = walk if walking else stand
        carry = convert.from_numpy(tcl.LoopCarry, st["carry"], CPU)
        kc = convert.from_numpy(tb.KktCarry, st["kkt_carry"], CPU)
        cs = {"card": convert.from_numpy(CtrlState, st["cs"], CPU)}
        step = dict(device=CPU, **(dict(kw, kkt_carry=kc) if amortized
                                   else kw))
        cs["cpu32"] = tb.batched_closed_loop_step(
            tcfg, tpb, tterr, carry, joy, dt, **step)[0].cs
        step64 = dict(step, kkt_carry=to64(kc)) if amortized else step
        cs["cpu64"] = tb.batched_closed_loop_step(
            tcfg, to64(tpb), to64(tterr), to64(carry), to64(joy),
            dt.double(), **step64)[0].cs
        jc = jstep(to_jax(shapes[2], carry), to_jax(kc_shape, kc),
                   jwalk if walking else jstand)[0]
        cs["jax"] = convert.from_numpy(CtrlState, jax_to_dict(jc.cs), CPU)
        devs = {w: deviations(tcfg, tpb, tree_map(
            lambda a: a.float() if a.is_floating_point() else a, cs[w]),
            dt) for w in WAYS}
        forces = {w: golden._world_forces(cs[w]).numpy() for w in WAYS}
        for w in WAYS[1:]:
            force_gap[w] = max(force_gap[w], float(np.abs(
                forces[w] - forces["card"]).max()))
        for w in WAYS:
            totals[w] += int((devs[w] > tol).sum())
        for i in range(b):
            if any(devs[w][i] > tol for w in WAYS):
                rows.append(dict(t=t, scenario=i, **{
                    w: round(float(devs[w][i]), 4) for w in WAYS}))
                print("  t={t} scen {scenario}: ".format(**rows[-1])
                      + ", ".join(f"{w} {rows[-1][w]:.3f} N" for w in WAYS),
                      flush=True)
    return dict(ticks=sorted(dump["states"]),
                samples=b * len(dump["states"]), over_tol=totals,
                max_force_gap_to_card_N=force_gap, rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    cap = sub.add_parser("capture")
    cap.add_argument("ticks")
    cap.add_argument("--out", required=True)
    cap.add_argument("--backend", default="amortized",
                     choices=golden.GATE_BACKENDS)
    cap.add_argument("--device", default="cuda")
    rep = sub.add_parser("replay")
    rep.add_argument("states")
    rep.add_argument("--tol", type=float, default=golden.TOL_N)
    sub.add_parser("jax-gate").add_argument(
        "--backend", default="amortized", choices=golden.GATE_BACKENDS)
    pln = sub.add_parser("plain")
    pln.add_argument("kernels", help="K1 or K1,K2")
    pln.add_argument("--device", default="cuda")
    pln.add_argument("--seconds", type=float, default=2.5)
    pln.add_argument("--walk-after", type=float, default=1.0)
    pln.add_argument("--workers", type=int,
                     default=max(1, (os.cpu_count() or 1) - 1))
    shd = sub.add_parser("shadow")
    shd.add_argument("--device", default="cuda")
    shd.add_argument("--kernel", default="K2", choices=("K2", "K4"))
    sub.add_parser("orders")
    par = sub.add_parser("paired")
    par.add_argument("--base", default="kernels",
                     choices=("kernels", "plain"))
    par.add_argument("--device", default="cuda")
    par.add_argument("--seconds", type=float, default=2.5)
    par.add_argument("--walk-after", type=float, default=1.0)
    par.add_argument("--workers", type=int,
                     default=max(1, (os.cpu_count() or 1) - 1))
    args = ap.parse_args(argv)
    if args.cmd == "capture":
        capture({int(t) for t in args.ticks.split(",")}, args.out,
                args.backend, device=args.device)
    elif args.cmd == "plain":
        names = args.kernels.split(",")
        if not names or set(names) - set(PLAIN):
            ap.error(f"kernels are of {sorted(PLAIN)}")
        print(json.dumps(plain_gate(names, args.workers, args.device,
                                    args.seconds, args.walk_after)))
    elif args.cmd == "orders":
        torch.set_num_threads(4)
        print(json.dumps(xt_orders()))
    elif args.cmd == "shadow":
        print(json.dumps(shadow_gate(args.device, args.kernel)))
    elif args.cmd == "paired":
        print(json.dumps(paired_gate(args.workers, args.device,
                                     base=args.base, seconds=args.seconds,
                                     walk_after_s=args.walk_after)))
    else:
        torch.set_num_threads(4)
        print(json.dumps(replay(args.states, args.tol)
                         if args.cmd == "replay"
                         else jax_gate(args.backend)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
