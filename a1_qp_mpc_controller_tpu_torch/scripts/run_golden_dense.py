"""The single-scenario golden gates at the protocols of the records in
``GOLDEN_REPORT.json`` (counterpart of ``scripts/run_golden_dense.py``),
every tick sampled:

- ``adaptive``: ``gazebo_mpc``, the adaptive solver (at most 1000
  iterations), 10 s;
- ``fixed_25it_rescue``: the shipped bench schedule (25 iterations, the
  150-iteration rescue over the strided 32-tick cooldown window, the
  0.5 N drift trigger), 10 s, with the OSQP-default columns;
- ``fixed_50it``: 50 fixed iterations, 10 s;
- ``stand_adaptive``, ``stand_fixed``: ``gazebo_qp``, 5 s;
- ``stand_lockstep_batched``: the lock-step batched stand route,
  3 scenarios, 5 s.

    python -m a1_qp_mpc_controller_tpu_torch.scripts.run_golden_dense \
        [--only fixed_25it_rescue,...] [--out build/golden_dense.json]

Each gate's report gains its wall time and, when the repository's
``GOLDEN_REPORT.json`` (the JAX package's record) is found, that
record's numbers under ``record``. The float64 solves of the
single-scenario gates run in a pool of ``--workers`` processes beside
the rollout. The JSON is written after every gate.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from a1_qp_mpc_controller_tpu_torch.runtime import golden

ROOT = Path(__file__).resolve().parents[2]
RECORD = ROOT / "GOLDEN_REPORT.json"
RECORD_KEYS = ("samples", "max_dev_N", "mean_dev_N", "p95_dev_N",
               "frac_within_tol", "alive_frac", "ref_osqp_default_max_dev_N",
               "ref_osqp_default_p95_dev_N",
               "ref_osqp_default_frac_within_tol")

# gate -> (run_gate arguments, description); the stand gates at 5 s
SHIPPED = dict(solver_mode="fixed", mpc_iters=25, rescue_iters=150,
               cooldown_ticks=32, cooldown_stride=4, cooldown_dense=12,
               drift_rescue_n=0.5)
GATES = {
    "adaptive": (dict(seconds=10.0, mpc_iters=1000),
                 "gazebo_mpc flat trot 0.3 m/s, adaptive solver (max 1000 "
                 "it), 10 s, every tick"),
    "fixed_25it_rescue": (dict(seconds=10.0, ref_fidelity_baseline=True,
                               **SHIPPED),
                          "gazebo_mpc flat trot 0.3 m/s, the bench "
                          "schedule: fixed 25 it + 150-it rescue over the "
                          "strided 32-tick cooldown window (dense 12, then "
                          "every 4th tick) + 0.5 N drift trigger, 10 s, "
                          "every tick"),
    "fixed_50it": (dict(seconds=10.0, solver_mode="fixed", mpc_iters=50),
                   "gazebo_mpc flat trot 0.3 m/s, fixed 50 it, 10 s, every "
                   "tick"),
    "stand_adaptive": (dict(seconds=5.0, profile="gazebo_qp",
                            solver_mode="adaptive", mpc_iters=50),
                       "gazebo_qp stand-QP trot, adaptive mode, 5 s, every "
                       "tick"),
    "stand_fixed": (dict(seconds=5.0, profile="gazebo_qp",
                         solver_mode="fixed", mpc_iters=50),
                    "gazebo_qp stand-QP trot, fixed mode, 5 s, every tick"),
    "stand_lockstep_batched": (None,
                               "gazebo_qp stand-QP trot, lock-step batched "
                               "route (fixed 100 it + gathered rescue), 3 "
                               "staggered scenarios, 5 s, every tick"),
}


def record(key: str) -> dict:
    """The JAX package's record of gate ``key``, or {} without one."""
    if not RECORD.exists():
        return {}
    rec = json.loads(RECORD.read_text()).get(key, {})
    return {k: rec[k] for k in RECORD_KEYS if k in rec}


def run(key: str, workers: int, device) -> dict:
    kwargs, config = GATES[key]
    t0 = time.perf_counter()
    if kwargs is None:
        rep = golden.run_stand_batched_gate(5.0, 1, 3, device=device)
    else:
        rep = golden.run_gate(sample_every=1, verbose=False,
                              workers=workers, device=device, **kwargs)
    rep["wall_s"] = time.perf_counter() - t0
    rep["config"] = config
    rep["record"] = record(key)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(GATES),
                    help="comma-separated gates, of: " + ", ".join(GATES))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "golden_dense.json"))
    ap.add_argument("--workers", type=int,
                    default=max(1, (os.cpu_count() or 1) - 1))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    keys = args.only.split(",")
    unknown = sorted(set(keys) - set(GATES))
    if unknown:
        ap.error(f"unknown gates {unknown}")
    print(f"cpus {os.cpu_count()}, workers {args.workers}, device "
          f"{args.device}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    report = {}
    for key in keys:
        report[key] = run(key, args.workers, args.device)
        print(f"{key}: {json.dumps(report[key])}", flush=True)
        out.write_text(json.dumps(report, indent=2))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
