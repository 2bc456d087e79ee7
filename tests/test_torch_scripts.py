"""The scripts' kernels S1 and S2 of the port (``ops/kernels_scripts.py``)
against the JAX scripts' Pallas bodies in interpret mode, on the same
seeded random NumPy inputs (inputs of ones, as the ladders use, hide
transposes and row/column mix-ups).

- S1 ``micro_admm``: the four variants at the script's N = 128, M = 256
  on B = 8 scenarios, 'full', 'dotgen' and 'nomatmul' at the script's 50
  iterations, 'nominv' at 3 (it diverges at the script's inputs, ~12x an
  iteration, and is NaN by 50). The script's ``run`` is loaded from its
  file, with ``pallas_call`` given ``interpret=True`` in this test only.
  Limit: 1e-4 of each output's scale on every scenario (K2's limit: the
  products sum in another order over 50 iterations; the 8 scenarios of
  seed 0 are ones float32 leaves stable, within ~2e-5 of a float64 run,
  where at B = 1024 most are not: ``scripts/micro_admm.py``). The scale
  is the output's largest entry; for y it is at least the largest
  rho z, because y + rho (zp - z) is a difference of terms of that size:
  where no bound is active y falls to that difference's rounding floor
  (~1e-9 in 'nomatmul'), whose digits no two summation orders share.
- S2 ``mosaic_probe``: every probe body at its smallest ladder shape, and
  rank1, thin_transpose and slab_axis0 also at (24, 24, 128); the grid
  negate of ``probe_mosaic4.py`` on a grid of 2 lane blocks. Limit: 1e-6
  of the largest entry (XLA's CPU code may fuse a multiply and a subtract
  into one rounding where PyTorch rounds twice).

The ``cuda``-marked tests hold each kernel against its plain version on
the card (S2 bit for bit; S1 by the port script's check, with every
unroll of a variant bit-equal to the others, since an unroll changes no
operation or its order) and skip without a card. JAX is imported only
inside the CPU tests, so ``python -m pytest --noconftest -m cuda
tests/test_torch_scripts.py`` runs on a machine without JAX.
"""

import functools
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops import kernels_scripts as ks
from a1_qp_mpc_controller_tpu_torch.scripts import (
    micro_admm as micro_admm_script,
)

from torch_parity import t

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
B = 8
S1_TOL = 1e-4
S2_TOL = 1e-6
# variant -> iterations compared ('nominv' diverges: see above)
S1_ITERS = {"full": 50, "dotgen": 50, "nomatmul": 50, "nominv": 3}
# (script, JAX body, port body, shape, steps): the smallest ladder shape
# of each body, and (24, 24, 128) for the three bodies with
# read-before-write steps that the ladders run only at 120 x 120
S2_CASES = [
    ("probe_mosaic", "k_negate", "negate", (8, 8, 128), 0),
    ("probe_mosaic", "k_fori_mask", "fori_mask", (8, 8, 128), 8),
    ("probe_mosaic", "k_axis1_reduce", "axis1_reduce", (8, 8, 128), 8),
    ("probe_mosaic", "k_axis0_reduce", "axis0_reduce", (8, 8, 128), 8),
    ("probe_mosaic", "k_dyn_read", "dyn_read", (8, 8, 128), 8),
    ("probe_mosaic", "k_dyn_store", "dyn_store", (8, 8, 128), 8),
    ("probe_mosaic", "k_carry_vec", "carry_vec", (8, 8, 128), 8),
    ("probe_mosaic", "k_rank1", "rank1", (8, 8, 128), 8),
    ("probe_mosaic", "k_rank1", "rank1", (24, 24, 128), 24),
    ("probe_mosaic2", "k_axis0_reduce", "axis0_reduce", (8, 120, 128), 8),
    ("probe_mosaic2", "k_thin_transpose", "thin_transpose", (24, 24, 128),
     24),
    ("probe_mosaic2", "k_thin_transpose", "thin_transpose", (120, 120, 128),
     120),
    ("probe_mosaic2", "k_carry_const", "carry_const", (120, 120, 128), 120),
    ("probe_mosaic2", "k_slab_axis0", "slab_axis0", (24, 24, 128), 24),
    ("probe_mosaic2", "k_slab_axis0", "slab_axis0", (120, 120, 128), 120),
]


def _script(name):
    """A fresh copy of ``scripts/<name>.py`` (its jitted functions trace
    anew), with ``pallas_call`` given ``interpret=True``."""
    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, ds=pl.ds)
    return mod


def _s1_inputs(b, seed=0):
    """The script's input families (scales and offsets), from a seed."""
    r = np.random.default_rng(seed)
    nrm = lambda *s: r.standard_normal(s).astype(np.float32)
    n, m = ks.N, ks.M
    return dict(
        a0=nrm(m, n) * 0.1, minv=nrm(b, n, n) * 0.01,
        e=np.abs(nrm(b, m)) + 0.5, q=nrm(b, n),
        l=-np.abs(nrm(b, m)) - 1, u=np.abs(nrm(b, m)) + 1,
        rho=np.abs(nrm(b, m)) + 0.1, x=nrm(b, n) * 0.1,
        y=np.zeros((b, m), np.float32), z=np.zeros((b, m), np.float32))


def _rel_close(port, ref, tol, what, scale=0.0):
    ref = np.asarray(ref)
    port = np.asarray(port)
    assert np.isfinite(ref).all() and np.isfinite(port).all(), what
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), scale)
    assert err <= tol, (what, err)


def _s1_close(out, ref, rho, what):
    """x, y, z within S1_TOL of their scales (the module docstring)."""
    out = [np.asarray(o) for o in out]
    ref = [np.asarray(r) for r in ref]
    rho_z = float(np.abs(np.asarray(rho) * ref[2]).max())
    for name, o, r in zip("xyz", out, ref):
        _rel_close(o, r, S1_TOL, f"{what} {name}",
                   scale=rho_z if name == "y" else 0.0)


@pytest.mark.parametrize("variant", ks.VARIANTS)
def test_micro_admm_matches_jax(variant):
    import jax.numpy as jnp

    mod = _script("micro_admm")
    mod.ITERS = S1_ITERS[variant]
    ins = _s1_inputs(B)
    ref = mod.run(*(jnp.asarray(v) for v in ins.values()), variant=variant,
                  block=B)
    out = ks.micro_admm(*(t(v) for v in ins.values()), variant=variant,
                        iters=S1_ITERS[variant])
    _s1_close([o.numpy() for o in out], ref, ins["rho"], variant)
    # the variants differ where the script says they do
    if variant == "dotgen":
        full = ks.micro_admm_plain(*(t(v) for v in ins.values()),
                                   variant="full", iters=50)
        assert not torch.allclose(full[0], out[0], rtol=1e-3)


def test_micro_admm_nominv_diverges_at_the_scripts_iterations():
    """'nominv' is a timing-only variant: at 50 iterations on the
    script's inputs it is no longer finite (so it is compared at 3)."""
    ins = _s1_inputs(B)
    x, y, _ = ks.micro_admm(*(t(v) for v in ins.values()), variant="nominv")
    assert not bool(torch.isfinite(x).all())


@pytest.mark.parametrize("case", S2_CASES,
                         ids=[f"{c[2]}-{'x'.join(map(str, c[3]))}"
                              for c in S2_CASES])
def test_probe_bodies_match_jax(case):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    script, jname, body, shape, n = case
    mod = _script(script)
    kern = getattr(mod, jname)
    if n:
        kern = functools.partial(kern, n=n)
        if body == "slab_axis0":
            kern = functools.partial(kern, chunk=8)
    spec = pl.BlockSpec(shape, lambda: (0,) * len(shape))
    f = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(shape,
                                                            jnp.float32),
                       in_specs=[spec], out_specs=spec, interpret=True)
    m = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.jit(f)(jnp.asarray(m)))
    out = ks.mosaic_probe(body, t(m), n).numpy()
    _rel_close(out, ref, S2_TOL, f"{body} {shape}")
    assert not np.array_equal(out, m) or body == "negate"


def test_grid_negate_matches_jax():
    """``probe_mosaic4.py``'s negate over a grid of lane blocks, at two
    blocks of 128 lanes."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    mod = _script("probe_mosaic4")
    shape, blk = (8, 8, 256), (8, 8, 128)
    spec = pl.BlockSpec(blk, lambda i: (0, 0, i))
    f = pl.pallas_call(mod.k_negate, grid=(2,),
                       out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                       in_specs=[spec], out_specs=spec, interpret=True)
    m = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jax.jit(f)(jnp.asarray(m)))
    np.testing.assert_array_equal(ks.mosaic_probe("negate", t(m)).numpy(),
                                  ref)


def test_probe_steps_are_checked():
    m = torch.zeros((8, 4, 128))
    with pytest.raises(ValueError):
        ks.mosaic_probe("fori_mask", m, 5)          # 5 columns of 4
    with pytest.raises(ValueError):
        ks.mosaic_probe("thin_transpose", m, 4)     # not square
    with pytest.raises(ValueError):
        ks.mosaic_probe("nope", m, 1)
    with pytest.raises(ValueError):                 # beyond shared memory
        ks.mosaic_probe("rank1", torch.zeros((300, 300, 1)), 1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ks.VARIANTS)
def test_micro_admm_kernel_matches_plain_on_card(card, variant):
    """At B = 256 on the script's inputs: each unroll of the variant
    against the plain version by ``scripts.micro_admm.check`` (1e-4 of
    each output's scale on every scenario at 3 iterations, and at 50 on
    the float32-stable ones: over 50 iterations these random inputs
    amplify rounding on most scenarios), the unrolls bit-equal to each
    other, one launch counted a call."""
    ins = micro_admm_script.make_inputs(256, card)
    outs = []
    for unroll in ks.UNROLLS:
        before = kernels.launches["micro_admm"]
        res = micro_admm_script.check(ins, variant, unroll)
        torch.cuda.synchronize()
        assert res["ok"], res
        assert kernels.launches["micro_admm"] == before + 2
        outs.append(ks.micro_admm(**ins, variant=variant, iters=3,
                                  unroll=unroll))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", S2_CASES,
                         ids=[f"{c[2]}-{'x'.join(map(str, c[3]))}"
                              for c in S2_CASES])
def test_probe_kernels_match_plain_on_card(card, case):
    _, _, body, shape, n = case
    m = t(np.random.default_rng(11).standard_normal(shape).astype(
        np.float32)).to(card)
    before = kernels.launches["mosaic_probes"]
    out = ks.mosaic_probe(body, m, n)
    torch.cuda.synchronize()
    assert kernels.launches["mosaic_probes"] == before + 1
    assert torch.equal(out, ks.mosaic_probe_plain(body, m, n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 8, 128), (5, 7, 9)])
def test_fori_mask_kernel_bit_equal_at_every_step_count(card, shape):
    """The elementwise fori_mask at n = 0, 3 and nj columns doubled, on a
    shape whose float4s share a column and on one whose do not."""
    m = t(np.random.default_rng(13).standard_normal(shape).astype(
        np.float32)).to(card)
    for n in (0, 3, shape[1]):
        out = ks.mosaic_probe("fori_mask", m, n)
        torch.cuda.synchronize()
        assert torch.equal(out, ks.mosaic_probe_plain("fori_mask", m, n)), n


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_negate_kernel_bit_equal_at_odd_totals_and_offsets(card, offset):
    """The vectorised negate on an odd total (5 x 7 x 9), and on a view
    that starts ``offset`` floats into its storage (no longer 16-byte
    aligned with its output), bit for bit."""
    flat = t(np.random.default_rng(14).standard_normal(315 + 3).astype(
        np.float32)).to(card)
    m = flat[offset:offset + 315].view(5, 7, 9)
    for body in ("negate", "fori_mask"):
        out = ks.mosaic_probe(body, m, 4 if body == "fori_mask" else 0)
        torch.cuda.synchronize()
        ref = ks.mosaic_probe_plain(body, m, 4 if body == "fori_mask" else 0)
        assert torch.equal(out, ref), body
