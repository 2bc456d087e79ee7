"""The batched golden gate of the MPC bench route at the protocol of the
records ``amortized_batched`` and ``gj_batched_gate`` in
``GOLDEN_REPORT.json`` (counterpart of ``scripts/run_golden_amortized.py``):
``runtime.golden.run_amortized_gate``, 16 staggered scenarios of the
record's randomized draws, 2.5 s with the walk from 1 s, every 3rd tick
from the onset (3,200 samples), the bench schedule with the capacities
scaled to the batch.

    python -m a1_qp_mpc_controller_tpu_torch.scripts.run_golden_amortized \
        [--backend amortized,gj] [--out build/golden_amortized.json]

``--walk-after 1.25 --seconds 2.75`` keeps the 3,200 samples on another
trajectory: the walk starts at another point of the staggered gaits.

Per backend: the gate's report, its wall time, the launches of K1
(``batched_inverse``) and K2 (``fused_admm_shared``) in it, and the
record's numbers under ``record``; every sample's (t, scenario, ticks
since the flip, KKT age, converged) and deviation go to
``<out stem>_<backend>.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.runtime import golden
from a1_qp_mpc_controller_tpu_torch.scripts.run_golden_dense import (
    ROOT, record,
)

# backend -> the record's key
KEYS = {"amortized": "amortized_batched", "gj": "gj_batched_gate"}
LAUNCHED = ("batched_inverse", "fused_admm_shared")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=2.5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--sample-every", type=int, default=3)
    ap.add_argument("--walk-after", type=float, default=1.0,
                    help="seconds standing before the walk (the record's "
                    "1.0; another value gives a second trajectory)")
    ap.add_argument("--backend", default="amortized",
                    help="comma-separated, of: " + ", ".join(KEYS))
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "golden_amortized.json"))
    ap.add_argument("--workers", type=int,
                    default=max(1, (os.cpu_count() or 1) - 1))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    backends = args.backend.split(",")
    unknown = sorted(set(backends) - set(KEYS))
    if unknown:
        ap.error(f"unknown backends {unknown}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    print(f"cpus {os.cpu_count()}, workers {args.workers}, device "
          f"{args.device}", flush=True)
    report = {}
    for backend in backends:
        kernels.reset_launches()
        t0 = time.perf_counter()
        rep = golden.run_amortized_gate(
            args.seconds, args.batch, args.sample_every, args.walk_after,
            backend=backend, workers=args.workers, verbose=True,
            device=args.device,
            detail_path=str(out.with_name(f"{out.stem}_{backend}.npz")))
        rep["wall_s"] = time.perf_counter() - t0
        rep["launches"] = {k: kernels.launches[k] for k in LAUNCHED}
        rep["config"] = (f"gazebo_mpc flat trot 0.3 m/s, batched "
                         f"'{backend}' route (bench schedule, capacities "
                         f"scaled to batch {args.batch}), {args.seconds} "
                         f"s, walk from {args.walk_after} s, staggered "
                         f"phases, sampled every {args.sample_every} ticks "
                         f"from the onset")
        rep["record"] = record(KEYS[backend])
        report[KEYS[backend]] = rep
        print(f"{KEYS[backend]}: {json.dumps(rep)}", flush=True)
        out.write_text(json.dumps(report, indent=2))
    print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
