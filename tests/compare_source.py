"""A kernel of this tree against the same kernel compiled from another
source of the same interface (as a rule the parent commit's), in turns on
the card:

    mkdir -p build/other
    git show HEAD~1:a1_qp_mpc_controller_tpu_torch/csrc/fused_admm_shared.cu \\
        > build/other/fused_admm_shared.cu
    python tests/compare_source.py K2 build/other/fused_admm_shared.cu
    git show HEAD~1:a1_qp_mpc_controller_tpu_torch/csrc/gj_rank.cu \\
        > build/other/gj_rank.cu
    python tests/compare_source.py K6de build/other/gj_rank.cu

- ``K2`` (``csrc/fused_admm_shared.cu``): on the operands of a real
  B = 1024 trot tick (``chip_smoke.real_tick``) at phase 3c's full-size
  shapes and the amortized gate's, for each source: the largest
  difference from the plain version and from the plain iterations in
  float64 (of each output's scale), the median over scenarios of the
  float64 primal residual ||A x - z||_inf over the plain version's, and
  the time. Then K2's ms a tick by name on the bench route 'amortized'
  (``chip_smoke.run_route``'s profile) from one warmed state.
- ``K6de`` (``csrc/gj_rank.cu``): K6d at ranks 2 and 4 and K6e at 8 and
  4 (the component profile's) on the tick's KKT batch at (1024, 120) and
  its leading (64, 30) block: each source bit-equal to the plain version
  (so to each other), and the time, with ``torch.linalg.inv`` on the
  same batch timed in the same turns.

Each source's times are ``chip_smoke.cuda_ms`` means in the order other,
this, this, other (``torch.linalg.inv`` after each). Needs the card;
imports nothing of JAX. Writes the numbers as JSON to ``--out`` (default
``build/<kernel>_source.json``).
"""

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

K2_SHAPES = ((1024, 25), (1024, 150)) + cs.GATE_K2_SHAPES
ORDER = ("other", "this", "this", "other")
# kernel -> (library, [(symbol, argtypes)]): the entries that swap
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    "K2": ("fused_admm_shared",
           [("launch", None)]),
    "K6de": ("gj_rank",
             [("launch", [_P, _P] + [_I] * 3 + [_P]),
              ("masked_launch", [_P, _P] + [_I] * 3 + [_P])]),
}


def prim64(ops, x, z):
    """(B,) ||e (A0 + mu A1) d x - z||_inf of scaled iterates in float64."""
    xd = ops["d"].double() * x.double()
    ax = ops["e"].double() * (xd @ ops["a0"].double().T
                              + ops["mu"].double()[:, None]
                              * (xd @ ops["a1"].double().T))
    return (ax - z.double()).abs().amax(dim=1)


def sources(k, kernel, other):
    """Build ``other`` and return use(name): within it, the port's
    entries of ``kernel`` run 'this' tree's or the 'other' source's."""
    lib_name, entries = ENTRIES[kernel]
    src = Path(other).resolve()
    lib = src.with_suffix(".so")
    build = subprocess.run([k._nvcc(), *k.NVCC_FLAGS, "-o", str(lib),
                            str(src)], capture_output=True, text=True)
    cs.log(build.stdout + build.stderr)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}")
    dll = ctypes.CDLL(str(lib))
    fns = {"this": {}, "other": {}}
    for symbol, argtypes in entries:
        key = f"{lib_name}_{symbol}"
        fns["this"][key] = k._fn(lib_name, symbol, argtypes)
        fn = getattr(dll, key)
        fn.argtypes = fns["this"][key].argtypes
        fn.restype = ctypes.c_int
        fns["other"][key] = fn

    def use(name):
        k._fns.update(fns[name])
    return use


def in_turns(use, run, extra=None) -> dict:
    """Mean ms of ``run`` under each source in ORDER, and of ``extra``
    (a library call) after each turn."""
    times = {name: [] for name in ("other", "this")}
    lib = []
    for name in ORDER:
        use(name)
        times[name].append(cs.cuda_ms(run, 20))
        if extra is not None:
            lib.append(cs.cuda_ms(extra, 20))
    use("this")
    out = {f"{name}_ms": statistics.fmean(t) for name, t in times.items()}
    out.update({f"{name}_ms_each": t for name, t in times.items()})
    if extra is not None:
        out["library_ms"] = statistics.fmean(lib)
    return out


def compare_k2(port, use, dev) -> dict:
    import torch
    k = port.kernels
    tick = cs.real_tick(port, dev)
    ops_full = tick["ops_full"](k.batched_inverse(tick["m_full"]))
    out = {}
    for b, iters in K2_SHAPES:
        ops = {key: v if key in ("a0", "a1") else v[:b].contiguous()
               for key, v in ops_full.items()}
        plain = dict(iters=iters, sigma=1e-6, alpha=1.6)
        ref = k.fused_admm_shared_plain(**ops, **plain)
        ref64 = k.fused_admm_shared_plain(
            **{key: v.double() for key, v in ops.items()}, **plain)
        res_plain = prim64(ops, ref[0], ref[2])
        row = {}
        for name in ("this", "other"):
            use(name)
            o = k.fused_admm_shared(**ops, iters=iters)
            torch.cuda.synchronize()
            row[name] = dict(
                rel_plain=[float((a - r).abs().max() / r.abs().max())
                           for a, r in zip(o, ref)],
                rel_f64=[float((a.double() - r).abs().max() / r.abs().max())
                         for a, r in zip(o, ref64)],
                prim64_ratio_median=float(
                    (prim64(ops, o[0], o[2]) / res_plain).median()))
        row.update(in_turns(use, lambda: k.fused_admm_shared(**ops,
                                                             iters=iters)))
        out[f"{b}x{iters}"] = row
        cs.log(f"K2 {b}x{iters}: {json.dumps(row)}")

    cfg, pb, terr, carry, joy_s, joy_w = cs.setup(port, cs.BATCH, dev)
    carry = cs.warm(port, cfg, pb, terr, carry, joy_s, joy_w, dev,
                    cs.STAND_TICKS, cs.WALK_TICKS)
    env = (cfg, pb, terr, joy_w)
    route = {"this": [], "other": []}
    for name in ORDER:
        use(name)
        m = cs.run_route(port, "amortized", env, carry, dev)
        named = m["profile"]["named_kernels"] if m["profile"] else {}
        route[name].append(dict(
            k2_ms_tick=named.get("K2", (None, None))[0],
            k2_launches_tick=named.get("K2", (None, None))[1],
            k2_pack_ms_tick=named.get("K2 pack", (None, None))[0],
            tick_ms_mean=m["tick_ms_mean"], converged=m["converged"],
            alive=m["alive"]))
        cs.log(f"amortized with {name} K2: {route[name][-1]}")
    use("this")
    out["amortized_route"] = route
    return out


def compare_k6de(port, use, dev) -> dict:
    import torch
    r = port.kernels_retired
    m = cs.real_tick(port, dev)["m_full"]
    out = {}
    for x in (m, m[:64, :30, :30].contiguous()):
        for label, entry, plain, ranks in (
                ("K6d", r.batched_inverse_rank,
                 r.batched_inverse_rank_plain, cs.K6D_RANKS),
                ("K6e", r.batched_inverse_rank_masked,
                 r.batched_inverse_rank_masked_plain, cs.K6E_RANKS)):
            for k in ranks:
                ref = plain(x, rank=k)
                row = {}
                for name in ("this", "other"):
                    use(name)
                    got = entry(x, rank=k)
                    torch.cuda.synchronize()
                    row[f"{name}_equal_plain"] = bool(torch.equal(got, ref))
                row.update(in_turns(
                    use, lambda: entry(x, rank=k),
                    lambda: torch.linalg.inv(x)))
                key = f"{label} r={k} {tuple(x.shape)}"
                out[key] = row
                cs.log(f"{key}: {json.dumps(row)}")
                if not (row["this_equal_plain"] and row["other_equal_plain"]):
                    raise AssertionError(f"{key} differs from its plain "
                                         "version")
    return out


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(ENTRIES))
    ap.add_argument("other", help="the other source of the kernel")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_source: no CUDA device", file=sys.stderr)
        return 1
    port = cs.Port()
    dev = torch.device("cuda")
    cs.log(cs.card_line())
    use = sources(port.kernels, args.kernel, args.other)
    out = (compare_k2 if args.kernel == "K2" else compare_k6de)(
        port, use, dev)
    path = Path(args.out or ROOT / "build" / f"{args.kernel}_source.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    cs.log(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
