"""Micro-benchmarks of the fused ADMM's inner loop on the card
(counterpart of ``scripts/micro_admm.py``): the four variants of S1
(``ops/kernels_scripts.micro_admm``) at N = 128, M = 256 and 50
iterations, each with the iteration loop unrolled 1 and 4 times:

    python -m a1_qp_mpc_controller_tpu_torch.scripts.micro_admm --batch 1024

The inputs are the script's families from seed 0 (``torch.Generator`` on
the CPU, then moved to the device). Each configuration is timed best of
5 with CUDA events (each the mean of 10 calls queued behind a spin of
the card, so the time is the kernel's, not the host's launches), and
held against its plain PyTorch version:

- at 3 iterations, every scenario within 1e-4 of each output's scale;
- at the script's 50 iterations ('nominv' diverges there: it is a
  timing-only variant, and both versions must have left the finite
  numbers), within 1e-4 on the scenarios that float32 rounding leaves
  stable: those on which the plain version in float32 and in float64
  agree within 1e-6. On these random inputs 'full' and 'dotgen' amplify
  rounding over 50 iterations (any two float32 summation orders part by
  up to ~1e-1 on a few percent of 1,024 scenarios), so no float32 code
  can be held to 1e-4 on the others; their share and largest difference
  are printed.

The scale of y is at least the largest rho z: y + rho (zp - z) is a
difference of terms of that size. The TPU script's ``block`` (16/32/64
scenarios a VMEM tile) is fixed on Hopper: a block shares a0 across the
two scenarios whose minv an SM's registers hold, so the sweep is
variant x unroll. On the
CPU (``--device cpu``) the plain versions run and nothing is timed.
"""

from __future__ import annotations

import argparse
import sys

import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels_scripts as ks
from a1_qp_mpc_controller_tpu_torch.runtime.profiling import time_scan
from a1_qp_mpc_controller_tpu_torch.scripts.probe_mosaic import (
    SPIN_CYCLES, device_name,
)
from a1_qp_mpc_controller_tpu_torch.tensors import CUDA, resolve_device

SEED = 0
REPS = 5
REPEATS = 10          # calls queued behind the spin a rep
TOL = 1e-4            # K2's limit: the products sum in another order
STABLE = 1e-6         # float32 against float64 of the plain version
SHORT_ITERS = 3       # before rounding differences can grow


def make_inputs(b: int, device=CUDA, seed: int = SEED) -> dict:
    """The script's input families: a0 (M, N) shared, minv (B, N, N),
    e, l, u, rho (B, M) around their offsets, q, x (B, N), y = z = 0;
    keyed by the kernel's argument names."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    nrm = lambda *s: torch.randn(s, generator=g)
    n, m = ks.N, ks.M
    ins = dict(a0=nrm(m, n) * 0.1, minv=nrm(b, n, n) * 0.01,
               e=nrm(b, m).abs() + 0.5, q=nrm(b, n),
               l=-nrm(b, m).abs() - 1, u=nrm(b, m).abs() + 1,
               rho=nrm(b, m).abs() + 0.1, x=nrm(b, n) * 0.1,
               y=torch.zeros(b, m), z=torch.zeros(b, m))
    return {k: v.to(device) for k, v in ins.items()}


def _per_scenario(out, ref, scales) -> torch.Tensor:
    """(B,) largest |out - ref| over x, y, z, each of its scale."""
    return torch.stack([
        (o.double() - r.double()).abs().amax(dim=1) / s
        for o, r, s in zip(out, ref, scales)]).amax(dim=0)


def compare(out, ins: dict, variant: str, iters: int, every: bool) -> dict:
    """``out`` (x, y, z) against the plain version on ``ins``: every
    scenario (``every``) or the float32-stable ones within TOL (module
    docstring). Returns the largest differences, the held count and
    ``ok``."""
    ref = ks.micro_admm_plain(**ins, variant=variant, iters=iters)
    if not all(bool(torch.isfinite(t).all()) for t in (*out, *ref)):
        return dict(iters=iters, finite=False, ok=False)
    x, y, z = ref
    scales = (float(x.abs().max()),
              max(float(y.abs().max()), float((ins["rho"] * z).abs().max())),
              float(z.abs().max()))
    err = _per_scenario(out, ref, scales)
    if every:
        held = torch.ones_like(err, dtype=torch.bool)
    else:
        r64 = ks.micro_admm_plain(**{k: v.double() for k, v in ins.items()},
                                  variant=variant, iters=iters)
        held = _per_scenario(ref, r64, scales) <= STABLE
    err_held = float(err[held].max()) if bool(held.any()) else float("nan")
    return dict(iters=iters, finite=True, max_rel=float(err.max()),
                max_rel_held=err_held, held=int(held.sum()),
                batch=err.shape[0],
                max_abs=max(float((o - r).abs().max())
                            for o, r in zip(out, ref)),
                ok=bool(held.any()) and err_held <= TOL)


def check(ins: dict, variant: str, unroll: int, outs=None) -> dict:
    """One configuration against its plain version at SHORT_ITERS
    (every scenario) and at the script's iterations (the stable ones;
    'nominv': both versions no longer finite). ``outs``, a list, if
    given, receives the kernel's (x, y, z) at both counts."""
    run = lambda iters: ks.micro_admm(**ins, variant=variant, iters=iters,
                                      unroll=unroll)
    short_out, full_out = run(SHORT_ITERS), run(ks.ITERS)
    if outs is not None:
        outs += [short_out, full_out]
    short = compare(short_out, ins, variant, SHORT_ITERS, every=True)
    if variant == "nominv":
        ref = ks.micro_admm_plain(**ins, variant=variant, iters=ks.ITERS)
        gone = lambda xyz: not bool(torch.isfinite(xyz[0]).all())
        full = dict(iters=ks.ITERS, diverged=gone(full_out) and gone(ref))
        full["ok"] = full["diverged"]
    else:
        full = compare(full_out, ins, variant, ks.ITERS, every=False)
    return dict(short=short, full=full, ok=short["ok"] and full["ok"])


def run(batch: int = 1024, device=CUDA, printer=print) -> dict:
    """The sweep: {(variant, unroll): dict(ms=..., check=...)}; each
    unroll's outputs must equal unroll 1's bit for bit (an unroll changes
    no operation or its order; 'nominv' at 3 iterations only, its 50
    are NaN)."""
    device = resolve_device(device)
    ins = make_inputs(batch, device)
    out = {}
    for variant in ks.VARIANTS:
        first = None
        for unroll in ks.UNROLLS:
            ms = (time_scan(lambda _: ks.micro_admm(
                **ins, variant=variant, unroll=unroll), None,
                repeats=REPEATS, reps=REPS, spin_cycles=SPIN_CYCLES) * 1e3
                if device.type == "cuda" else None)
            outs = []
            res = check(ins, variant, unroll, outs)
            first = first or outs
            held = first[:1] if variant == "nominv" else first
            res["unrolls_equal"] = all(
                torch.equal(a, b) for xyz, ref in zip(outs, held)
                for a, b in zip(xyz, ref))
            res["ok"] = res["ok"] and res["unrolls_equal"]
            out[(variant, unroll)] = dict(ms=ms, check=res)
            f = res["full"]
            held = ("both diverged" if variant == "nominv" else
                    f"{f.get('held')}/{batch} stable held, max rel "
                    f"{f.get('max_rel_held', float('nan')):.2e} (all "
                    f"{f.get('max_rel', float('nan')):.2e})")
            timing = "not measured" if ms is None else f"{ms:9.3f} ms"
            printer(f"{variant} unroll={unroll:<2d} {timing}  "
                    f"{'PASS' if res['ok'] else 'FAIL'} vs plain: "
                    f"{SHORT_ITERS} it max rel "
                    f"{res['short'].get('max_rel', float('nan')):.2e}; "
                    f"{ks.ITERS} it {held}; equal to unroll 1 "
                    f"{res['unrolls_equal']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"batch={args.batch} iters={ks.ITERS} "
          f"device={device_name(device)}")
    res = run(args.batch, device)
    return 0 if all(r["check"]["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
