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
    for f in gj_inplace sweep_inverse; do git show \\
        HEAD~1:a1_qp_mpc_controller_tpu_torch/csrc/$f.cu > build/other/$f.cu
    done
    python tests/compare_source.py K6bf build/other/gj_inplace.cu \\
        build/other/sweep_inverse.cu
    git show HEAD~1:a1_qp_mpc_controller_tpu_torch/csrc/mosaic_probes.cu \\
        > build/other/mosaic_probes.cu
    python tests/compare_source.py S2 build/other/mosaic_probes.cu
    git show HEAD~1:a1_qp_mpc_controller_tpu_torch/csrc/chol_linv.cu \\
        > build/other/chol_linv.cu
    python tests/compare_source.py K5 build/other/chol_linv.cu

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
- ``K6bf``: K6b and K6f on ``csrc/inverse_t.cu`` against the design
  they left, one block a matrix in shared memory (two sources:
  ``gj_inplace.cu``, then ``sweep_inverse.cu``), on the tick's KKT batch
  at (1024, 120), its leading (64, 30) block and the first 64 bordered
  by identity to n = 136 (past the register tile): each source bit-equal
  to the plain version as int32 views (signed zeros count), and the
  time, ``torch.linalg.inv`` in the same turns.
- ``S2`` (``csrc/mosaic_probes.cu``): every probe of the two ladders
  (``scripts.probe_mosaic``, ``probe_mosaic2``) and ``probe_mosaic4``'s
  grid negate at its shape and steps, on a seeded random input: each
  source bit-equal to the plain version, and the time, the library call
  (``chip_smoke.s2_library``, where there is one) in the same turns.
- ``K5`` (``csrc/chol_linv.cu``): the panels ``spd_cholesky_inverse_hybrid``
  gives K5 on the tick's KKT batch (the first and the trailing, (1024,
  30)), a dense random SPD batch of that shape (no zero entries) and the
  batch's leading p x p blocks at ``chip_smoke.K5_PS``: each
  source bit-equal to the plain version, and the time, ``cholesky`` +
  ``solve_triangular`` in the same turns; then the hybrid on the whole
  batch with each source, its ||MX - I||_max beside
  ``spd_cholesky_inverse``'s.

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
_P, _I = ctypes.c_void_p, ctypes.c_int
_INV = [_P, _P, _I, _I, _P]           # (m, out, batch, n, stream)
_INV1 = [_P, _P, _I, _I, _I, _P]      # the same with one int option
_PROBE = [_I, _P, _P, _I, _I, _I, _I, _P]  # (body, m, o, ni, nj, s, n, stream)
# kernel -> the entries that swap: (library, symbol, argtypes, the other
# source's symbol (None: the same), the arguments it takes of this
# entry's (None: all)); with several other sources, entry i is taken from
# source i
ENTRIES = {
    "K2": [("fused_admm_shared", "launch", None, None, None)],
    "K6de": [("gj_rank", "launch", _INV1, None, None),
             ("gj_rank", "masked_launch", _INV1, None, None)],
    "K6bf": [("inverse_t", "inplace_launch", _INV, "gj_inplace_launch",
              None),
             ("inverse_t", "sweep_launch", _INV1, "sweep_inverse_launch",
              (0, 1, 2, 3, 5))],
    "S2": [("mosaic_probes", "launch", _PROBE, None, None)],
    "K5": [("chol_linv", "launch", _INV, None, None)],
}


def prim64(ops, x, z):
    """(B,) ||e (A0 + mu A1) d x - z||_inf of scaled iterates in float64."""
    xd = ops["d"].double() * x.double()
    ax = ops["e"].double() * (xd @ ops["a0"].double().T
                              + ops["mu"].double()[:, None]
                              * (xd @ ops["a1"].double().T))
    return (ax - z.double()).abs().amax(dim=1)


def sources(k, kernel, others):
    """Build ``others`` and return use(name): within it, the port's
    entries of ``kernel`` run 'this' tree's or the other sources'."""
    dlls = []
    for other in others:
        src = Path(other).resolve()
        lib = src.with_suffix(".so")
        build = subprocess.run([k._nvcc(), *k.NVCC_FLAGS, "-o", str(lib),
                                str(src)], capture_output=True, text=True)
        cs.log(build.stdout + build.stderr)
        if build.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}")
        dlls.append(ctypes.CDLL(str(lib)))
    fns = {"this": {}, "other": {}}
    for i, (lib_name, symbol, argtypes, other_symbol, keep) in enumerate(
            ENTRIES[kernel]):
        key = f"{lib_name}_{symbol}"
        fns["this"][key] = k._fn(lib_name, symbol, argtypes)
        fn = getattr(dlls[min(i, len(dlls) - 1)], other_symbol or key)
        types = fns["this"][key].argtypes
        fn.argtypes = types if keep is None else [types[a] for a in keep]
        fn.restype = ctypes.c_int
        fns["other"][key] = (fn if keep is None else
                             lambda *a, fn=fn, keep=keep:
                             fn(*(a[j] for j in keep)))

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


def compare_k6bf(port, use, dev) -> dict:
    import torch
    r = port.kernels_retired
    m = cs.real_tick(port, dev)["m_full"]
    bits = lambda x: x.view(torch.int32)
    out = {}
    for x in (m, m[:64, :30, :30].contiguous(), cs.identity_bordered(m)):
        for label, entry, plain in (
                ("K6b", r.batched_inverse_inplace,
                 r.batched_inverse_inplace_plain),
                ("K6f", r.batched_inverse_spd, r.batched_inverse_spd_plain)):
            ref = plain(x)
            row = {}
            for name in ("this", "other"):
                use(name)
                got = entry(x)
                torch.cuda.synchronize()
                row[f"{name}_equal_plain"] = bool(torch.equal(bits(got),
                                                              bits(ref)))
            row.update(in_turns(use, lambda: entry(x),
                                lambda: torch.linalg.inv(x)))
            key = f"{label} {tuple(x.shape)}"
            out[key] = row
            cs.log(f"{key}: {json.dumps(row)}")
            if not (row["this_equal_plain"] and row["other_equal_plain"]):
                raise AssertionError(f"{key} differs from its plain version")
    return out


def compare_s2(port, use, dev) -> dict:
    import torch
    ks = port.kernels_scripts
    g = torch.Generator().manual_seed(0)
    rungs = (port.probe_mosaic.LADDER + port.probe_mosaic2.LADDER
             + (("grid negate", "negate", port.probe_mosaic4.GRID_SHAPE,
                 0),))
    out = {}
    for name, body, shape, n in rungs:
        m = torch.randn(shape, generator=g).to(dev)
        ref = ks.mosaic_probe_plain(body, m, n)
        row = {}
        for src in ("this", "other"):
            use(src)
            got = ks.mosaic_probe(body, m, n)
            torch.cuda.synchronize()
            row[f"{src}_equal_plain"] = bool(torch.equal(got, ref))
        row.update(in_turns(use, lambda: ks.mosaic_probe(body, m, n),
                            cs.s2_library(body, m, n)))
        out[name] = row
        cs.log(f"S2 {name}: {json.dumps(row)}")
        if not (row["this_equal_plain"] and row["other_equal_plain"]):
            raise AssertionError(f"S2 {name} differs from its plain version")
    return out


def compare_k5(port, use, dev) -> dict:
    import torch
    k, linalg = port.kernels, port.linalg
    m = cs.real_tick(port, dev)["m_full"]
    _, _, panels = cs.hybrid_panels(port, m)
    # a dense SPD batch of the hybrid's panel size beside the KKT's
    # panels, which hold many exact zeros
    g = torch.Generator(device=dev).manual_seed(0)
    r = torch.randn(panels[0].shape, generator=g, device=dev)
    dense = r @ r.transpose(1, 2) / r.shape[-1] + 0.1 * torch.eye(
        r.shape[-1], device=dev)
    cases = [("first", panels[0]), ("trailing", panels[-1]),
             ("dense random", dense)] + [
        (f"leading p={p}", m[:, :p, :p].contiguous()) for p in cs.K5_PS]
    out = {}
    for label, a in cases:
        ref = k.batched_chol_linv_plain(a)
        row = {}
        for name in ("this", "other"):
            use(name)
            got = k.batched_chol_linv(a)
            torch.cuda.synchronize()
            row[f"{name}_equal_plain"] = bool(torch.equal(got, ref))
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        row.update(in_turns(use, lambda: k.batched_chol_linv(a),
                            lambda: torch.linalg.solve_triangular(
                                torch.linalg.cholesky(a), eye,
                                upper=False)))
        key = f"K5 {label} {tuple(a.shape)}"
        out[key] = row
        cs.log(f"{key}: {json.dumps(row)}")
        if not (row["this_equal_plain"] and row["other_equal_plain"]):
            raise AssertionError(f"{key} differs from its plain version")
    resid = port.components.resid_max
    out["resid"] = {"spd_cholesky_inverse": resid(
        m, linalg.spd_cholesky_inverse(m))}
    for name in ("this", "other"):
        use(name)
        out["resid"][f"hybrid {name}"] = resid(
            m, linalg.spd_cholesky_inverse_hybrid(m))
    use("this")
    cs.log(f"||MX - I||_max on {tuple(m.shape)}: {json.dumps(out['resid'])}")
    return out


COMPARE = {"K2": compare_k2, "K6de": compare_k6de, "K6bf": compare_k6bf,
           "S2": compare_s2, "K5": compare_k5}


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(ENTRIES))
    ap.add_argument("other", nargs="+",
                    help="the other source(s) of the kernel")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_source: no CUDA device", file=sys.stderr)
        return 1
    port = cs.Port()
    dev = torch.device("cuda")
    cs.log(cs.card_line())
    use = sources(port.kernels, args.kernel, args.other)
    out = COMPARE[args.kernel](port, use, dev)
    path = Path(args.out or ROOT / "build" / f"{args.kernel}_source.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    cs.log(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
