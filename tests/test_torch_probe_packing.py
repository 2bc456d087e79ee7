"""The decompositions that ``csrc/mosaic_probes.cu`` (S2) runs its probe
bodies by, checked on the CPU: a torch model of each kernel's layout and
order against ``ops/kernels_scripts.mosaic_probe_plain``, bit for bit
(``torch.equal``).

- The per-entry pass (negate, fori_mask, dyn_read, dyn_store,
  carry_const, slab_axis0): every output entry from one entry of m, at
  the source index the kernel reads (``Entry::source``), the float4s of
  the vector path reading four neighbouring sources.
- The chains (axis1_reduce's rows; axis0_reduce's and carry_vec's
  columns): g threads a chain, entry e in register e // g of part e % g,
  zeros past the chain's end, the pivot of step k from register k // g of
  part k % g, at every g from the least that keeps a thread's registers
  at 32 to 32 (the launcher picks among them).
- The register tile (rank1, thin_transpose): a 16 x 16 grid of RI x RJ
  tiles (each side ceil(n / 16) rounded up to a power of two, zeros past
  ni and nj), row k and column k staged from the threads that own them.

The shapes and steps are ``chip_smoke.py``'s (``S2_ODD_SHAPES``,
``s2_steps``), which its phase 5c holds the kernel at, with the ladders'
(8, 8, 128): ni != nj, n below ni, n = 0 and 1, S = 1, 3 and 128, and
tiles that pad (ni = 24, 120). The ``cuda``-marked cases hold the kernel
itself against its plain version at the same shapes, at the ladders'
(120, 120, 128), past the chain and tile limits (the shared-memory
tier), and, for the per-entry bodies, past the shared-memory limit that
bounds the other bodies' arrays; they skip without a card.
"""

import pytest
import torch

from a1_qp_mpc_controller_tpu_torch.ops import kernels
from a1_qp_mpc_controller_tpu_torch.ops import kernels_scripts as ks
from chip_smoke import S2_ODD_SHAPES, s2_steps

SIDE = 16           # the tile kernel's grid side
MAX_TILE = 8        # its largest register tile side
CHAIN_REGS = 32     # a chain thread's most registers

ENTRY = ("negate", "fori_mask", "dyn_read", "dyn_store", "carry_const",
         "slab_axis0")
CHAIN = ("axis1_reduce", "axis0_reduce", "carry_vec")
TILE = ("rank1", "thin_transpose")

# (ni, nj, S): the ladders' small shape and the odd shapes within the
# chains' and the tile's limits (the models' reach)
SHAPES = ((8, 8, 128),) + tuple(
    sh for sh in S2_ODD_SHAPES if max(sh[:2]) <= SIDE * MAX_TILE)
# past them: the shared-memory tier of the chains and the tile
WIDE = tuple(sh for sh in S2_ODD_SHAPES if sh not in SHAPES)
# past the shared-memory limit that bounds every array but the per-entry
# bodies'
PAST_SMEM = (250, 250, 2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensors, many steps: one thread, as the other port tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cases(bodies, shapes=SHAPES):
    return [(body, shape, n) for body in bodies for shape in shapes
            if body != "thin_transpose" or shape[0] == shape[1]
            for n in s2_steps(ks, body, shape)]


def seeded(shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g)


# --- the per-entry pass ---------------------------------------------------

def entry_source(body, e, row, n):
    """``Entry::source``: the element of m that output e reads."""
    if body in ("dyn_read", "slab_axis0") and n > 0:
        return torch.where(e < row, e + (n - 1) * row, e)
    if body == "dyn_store":
        return torch.where(e < n * row, e % row, e)
    return e


def entry_model(body, m, n):
    ni, nj, s = m.shape
    flat, row = m.reshape(-1), nj * s
    e = torch.arange(flat.numel())
    src = entry_source(body, e, row, n)
    if body in ("dyn_read", "dyn_store", "slab_axis0") and row % 4 == 0:
        # the vector path: a float4's four sources are neighbours
        e0 = e[::4]
        for c in range(4):
            assert torch.equal(entry_source(body, e0, row, n) + c,
                               src[e0 + c])
    v = flat[src]
    if body == "negate":
        out = -v
    elif body == "fori_mask":
        out = torch.where(e // s % nj < n, v * 2.0, v)
    elif body == "dyn_store":
        out = torch.where(e < n * row, v * 2.0, v)
    elif body == "slab_axis0":
        out = torch.where(e < row, 0.0 + v, v) if n > 0 else v
    elif body == "carry_const":
        out, r = v, torch.zeros(())
        for _ in range(n):
            out = out - 1e-6 * r
            r = r + 1.0
    else:                                       # dyn_read
        out = v
    return out.view(ni, nj, s)


@pytest.mark.parametrize("body,shape,n", cases(ENTRY))
def test_entry_pass_matches_plain(body, shape, n):
    m = seeded(shape)
    assert torch.equal(entry_model(body, m, n),
                       ks.mosaic_probe_plain(body, m, n))


@pytest.mark.parametrize("body", ks.BODIES)
def test_array_past_shared_memory(body):
    """The per-entry bodies take an array past the shared-memory limit;
    every other body refuses it."""
    m = seeded(PAST_SMEM, 4)
    n = s2_steps(ks, body, PAST_SMEM)[-1]
    if body not in ENTRY:
        with pytest.raises(ValueError, match="exceeds shared memory"):
            ks.mosaic_probe_plain(body, m, n)
        return
    assert torch.equal(entry_model(body, m, n),
                       ks.mosaic_probe_plain(body, m, n))


# --- the chains -----------------------------------------------------------

def chain_model(body, m, n, g):
    """The chain kernel at g threads a chain: each chain's entries in
    (R, g) registers, step k's pivot from register k // g of part k % g."""
    ni, nj, s = m.shape
    perm = (0, 2, 1) if body == "axis1_reduce" else (1, 2, 0)
    chains = m.permute(*perm)                     # (rows, S, len)
    length = chains.shape[-1]
    r = -(-length // g)
    regs = torch.zeros(chains.shape[:2] + (r * g,))
    regs[..., :length] = chains
    regs = regs.view(chains.shape[:2] + (r, g))   # [.., r, c]: entry r g + c
    carry = torch.zeros(chains.shape[:2])
    for k in range(n):
        p = regs[..., k // g, k % g].clone()
        if body == "carry_vec":
            q, carry = 1e-6 * carry, p
        else:
            q = 1e-6 * p
        regs = regs - q[..., None, None]
    out = regs.reshape(chains.shape[:2] + (r * g,))[..., :length]
    inv = [perm.index(d) for d in range(3)]
    return out.permute(*inv).contiguous()


@pytest.mark.parametrize("body,shape,n", cases(CHAIN))
def test_chains_match_plain_at_every_width(body, shape, n):
    """Every g the launcher may pick: from the least that keeps a
    thread's registers at CHAIN_REGS to 32."""
    ni, nj, _ = shape
    length = nj if body == "axis1_reduce" else ni
    m = seeded(shape, 1)
    ref = ks.mosaic_probe_plain(body, m, n)
    g = 1
    while g * CHAIN_REGS < length:
        g *= 2
    while g <= 32:
        assert torch.equal(chain_model(body, m, n, g), ref), g
        g *= 2


# --- the register tile ----------------------------------------------------

def tile_side(n):
    r = 1
    while SIDE * r < n:
        r *= 2
    return r


def tile_model(body, m, n):
    """The tile kernel: t[s, ty, tx, a, b] holds entry (ty + 16 a,
    tx + 16 b) of lane s; step k stages row k from the threads ty = k % 16
    (register row k // 16) and column k from tx = k % 16 (register
    column k // 16)."""
    ni, nj, s = m.shape
    ri, rj = tile_side(ni), tile_side(nj)
    assert ri <= MAX_TILE and rj <= MAX_TILE
    pad = torch.zeros((SIDE * ri, SIDE * rj, s))
    pad[:ni, :nj] = m
    # row ty + 16 a, column tx + 16 b -> [s, ty, tx, a, b]
    t = pad.view(ri, SIDE, rj, SIDE, s).permute(4, 1, 3, 0, 2).contiguous()
    for k in range(n):
        p, a0 = k % SIDE, k // SIDE
        col = t[:, :, p, :, a0].transpose(1, 2).reshape(s, -1)  # ty + 16 a
        row = (t[:, p, :, a0, :].transpose(1, 2).reshape(s, -1)
               if body == "rank1" else col)                     # tx + 16 b
        c = col.view(s, ri, SIDE).transpose(1, 2)[:, :, None, :, None]
        r = row.view(s, -1, SIDE).transpose(1, 2)[:, None, :, None, :]
        t = t - 1e-6 * (c * r)
    out = t.permute(3, 1, 4, 2, 0).reshape(SIDE * ri, SIDE * rj, s)
    return out[:ni, :nj].contiguous()


@pytest.mark.parametrize("body,shape,n", cases(TILE) + [
    ("rank1", (120, 120, 128), 120), ("thin_transpose", (24, 24, 128), 24)])
def test_tile_matches_plain(body, shape, n):
    m = seeded(shape, 2)
    assert torch.equal(tile_model(body, m, n),
                       ks.mosaic_probe_plain(body, m, n))


# --- the kernels on the card ----------------------------------------------

CARD_CASES = (cases(ENTRY + CHAIN + TILE, SHAPES + ((120, 120, 128),) + WIDE)
              + cases(ENTRY, (PAST_SMEM,)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("body,shape,n", CARD_CASES)
def test_probe_kernel_bit_equal_on_card(card, body, shape, n):
    m = seeded(shape, 3).to(card)
    before = kernels.launches["mosaic_probes"]
    out = ks.mosaic_probe(body, m, n)
    torch.cuda.synchronize()
    assert kernels.launches["mosaic_probes"] == before + 1
    assert torch.equal(out, ks.mosaic_probe_plain(body, m, n))
