"""The batched solver's kernels (counterpart of ``ops/pallas_kernels.py``'s
``batched_inverse``, ``batched_inverse_small``, ``batched_chol_linv``,
``fused_admm_shared`` and ``fused_admm``): hand-written CUDA for Hopper
(``csrc/``), each beside a plain PyTorch version with the same
arithmetic. The retired variants' kernels are bound in
``ops/kernels_retired.py``, the scripts' (S1, S2) in
``ops/kernels_scripts.py``, through the same build.

A wrapper takes the plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches its kernel or raises. Each launch adds
one to ``launches[name]``.

The CUDA sources are compiled at first use with nvcc for ``sm_90a`` into
plain-C shared libraries (one nvcc process per source, all started
together) under ``build/kernels/<source hash>/`` at the repository root,
and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
_SOURCES = {"chol_linv": "chol_linv.cu",
            "fused_admm_shared": "fused_admm_shared.cu",
            "fused_admm": "fused_admm.cu",
            "inverse_t": "inverse_t.cu",
            "gj_rank": "gj_rank.cu",
            "micro_admm": "micro_admm.cu",
            "mosaic_probes": "mosaic_probes.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_SMEM_BYTES = 232448     # per-block dynamic shared memory on Hopper
T_N_MAX = MAX_SMEM_BYTES // 16  # csrc/inverse_t.cu: 4n floats past n = 128
SMALL_N_MAX = 128           # batched_inverse_small's largest n
CHOL_P_MAX = 128            # batched_chol_linv's largest panel: 3 p^2 floats

launches = {"batched_inverse": 0, "batched_inverse_small": 0,
            "batched_chol_linv": 0, "fused_admm_shared": 0, "fused_admm": 0,
            "batched_inverse_T": 0, "batched_inverse_sweep_T": 0,
            "batched_inverse_inplace": 0, "batched_inverse_combined": 0,
            "batched_inverse_rank": 0, "batched_inverse_rank_masked": 0,
            "batched_inverse_spd": 0, "micro_admm": 0, "mosaic_probes": 0}
# K4's last launch on the card: (B,) int32, 1 where a block ran the dense
# order because its A did not fit the list slots
paths: dict[str, torch.Tensor] = {}
build_log: dict[str, str] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}

_P = ctypes.c_void_p
_ARGTYPES = {
    "fused_admm_shared": [_P] * 17 + [ctypes.c_int] * 4
    + [ctypes.c_float] * 3 + [_P],
    "fused_admm": [_P] * 13 + [ctypes.c_int] * 4
    + [ctypes.c_float] * 3 + [_P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    found = str(path) if path.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build_kernels() -> dict[str, Path]:
    """Compile every kernel source that has no library yet for the
    current source hash; returns {name: library path}."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_SOURCES.values()):
        h.update((_CSRC / src).read_bytes())
    out_dir = _BUILD / h.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {name: out_dir / f"lib{name}.so" for name in _SOURCES}
    jobs = {}
    for name, src in _SOURCES.items():
        if libs[name].exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp)
    for name, (proc, tmp) in jobs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SOURCES[name]}:\n{out}")
        os.replace(tmp, libs[name])
    return libs


def _fn(name: str, symbol: str = "launch", argtypes=None):
    key = f"{name}_{symbol}"
    if key not in _fns:
        lib = ctypes.CDLL(str(build_kernels()[name]))
        fn = getattr(lib, key)
        fn.argtypes = _ARGTYPES[name] if argtypes is None else argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


# --- K1, K3 and K5: Gauss-Jordan inverse, panel Cholesky inverse ---------

def _inverse(m: torch.Tensor, name: str, lib: str, plain, n_max: int,
             symbol: str = "launch", extra: tuple = ()):
    """The launch discipline K1, K3, K5 and K6b-K6f share: (B, n, n) with
    n <= n_max on any device, the plain version on the CPU, else the
    ``symbol`` kernel of ``lib`` (``extra`` int arguments after n),
    counted in ``launches[name]``."""
    if m.ndim != 3 or m.shape[1] != m.shape[2]:
        raise ValueError(f"{name}: expected (B, n, n), got "
                         f"{tuple(m.shape)}")
    b, n, _ = m.shape
    if n > n_max:
        raise ValueError(f"{name}: n={n} > {n_max}")
    if not _on_card(m):
        return plain(m)
    _check("m", m, (b, n, n), m.device)
    out = torch.empty_like(m)
    fn = _fn(lib, symbol, [_P, _P] + [ctypes.c_int] * (2 + len(extra))
             + [_P])
    rc = fn(m.data_ptr(), out.data_ptr(), b, n, *extra,
            torch.cuda.current_stream(m.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{lib}_{symbol} failed: CUDA error {rc}")
    launches[name] += 1
    return out


def batched_inverse_plain(m: torch.Tensor) -> torch.Tensor:
    """Pivot-free lock-step Gauss-Jordan inverse (B, n, n) -> (B, n, n),
    the arithmetic of ``_gj_inverse_kernel``: each pivot's elimination
    factor on the pivot row is ``diag - 1``, so one rank-1 update both
    eliminates the column and scales the pivot row."""
    b, n, _ = m.shape
    inv = torch.eye(n, dtype=m.dtype, device=m.device).expand(b, n, n)
    for k in range(n):
        diag = m[:, k:k + 1, k:k + 1]
        inv_d = 1.0 / diag
        row_m = m[:, k:k + 1, :] * inv_d
        row_i = inv[:, k:k + 1, :] * inv_d
        factor = m[:, :, k:k + 1].clone()
        factor[:, k] = diag[:, 0] - 1.0
        m = m - factor * row_m
        inv = inv - factor * row_i
    return inv


def batched_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of SPD matrices (B, n, n) through the CUDA
    Gauss-Jordan kernel (csrc/inverse_t.cu, its "diag - 1" rule set: the
    matrix in registers for n <= 128, in device memory past it),
    n <= 14,528; plain version on the CPU."""
    return _inverse(m, "batched_inverse", "inverse_t",
                    batched_inverse_plain, T_N_MAX, symbol="k1_launch")


def batched_inverse_small_plain(m: torch.Tensor) -> torch.Tensor:
    """The plain version of K3: the same pivot loop as
    :func:`batched_inverse_plain` (the TPU kernels share their body)."""
    return batched_inverse_plain(m)


def batched_inverse_small(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of small SPD matrices (B, n, n), n <= 128,
    through K1's register kernel (csrc/inverse_t.cu), its tile sized to
    n (16 ceil(n / 16)); plain version on the CPU."""
    return _inverse(m, "batched_inverse_small", "inverse_t",
                    batched_inverse_small_plain, SMALL_N_MAX,
                    symbol="k1_launch")


def inverse_reg_occupancy(n: int) -> dict:
    """The register kernel that n (<= 128) selects in csrc/inverse_t.cu
    (K1's and K3's rule set): its resident blocks (matrices) an SM by
    CUDA's occupancy calculator, its registers and its local memory (spill)
    bytes a thread."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    fn = _fn("inverse_t", "k1_occupancy", [ctypes.c_int, _P, _P])
    blocks = fn(n, ctypes.addressof(regs), ctypes.addressof(local))
    if blocks < 0:
        raise RuntimeError(f"inverse_t occupancy at n={n}: CUDA error "
                           f"{-blocks}")
    return dict(blocks=blocks, registers=regs.value,
                local_bytes=local.value)


def batched_chol_linv_plain(a: torch.Tensor) -> torch.Tensor:
    """L^-1 (lower) of SPD panels (B, p, p), A = L L', the arithmetic of
    ``_chol_linv_kernel``: p outer-product Cholesky steps ``a - colk rowk
    / akk`` on the trailing block with L' built row by row, then forward
    substitution ``(e_k - sum_r L[k, r] M[r, :]) / L[k, k]``, both
    divisors clamped at 1e-30. The substitution sums r = 0..k-1 in order,
    as the kernel does (the TPU kernel sums the zero terms r >= k too)."""
    b, p, _ = a.shape
    a = a.clone()
    lt = torch.zeros_like(a)
    for k in range(p):
        rowk = a[:, k, :].clone()                            # (B, p)
        akk = torch.clamp(rowk[:, k:k + 1], min=1e-30)       # (B, 1)
        colk = a[:, k + 1:, k]
        a[:, k + 1:, k + 1:] -= (colk[:, :, None] * rowk[:, None, k + 1:]
                                 / akk[:, :, None])
        sq = torch.sqrt(akk)
        lt[:, k, k] = sq[:, 0]
        lt[:, k, k + 1:] = rowk[:, k + 1:] / sq
    m = torch.zeros_like(a)
    eye = torch.eye(p, dtype=a.dtype, device=a.device)
    for k in range(p):
        prod = torch.zeros_like(m[:, k, :])
        for r in range(k):
            prod = prod + lt[:, r, k:k + 1] * m[:, r, :]
        m[:, k, :] = (eye[k] - prod) / torch.clamp(lt[:, k, k:k + 1],
                                                   min=1e-30)
    return m


def batched_chol_linv(a: torch.Tensor) -> torch.Tensor:
    """L^-1 of a batch of SPD panels (B, p, p) -> (B, p, p) lower
    triangular, A = L L', through the CUDA kernel (csrc/chol_linv.cu),
    p <= 128; plain version on the CPU. The exact p: the TPU version's
    identity tail to a multiple of 8 leaves the top-left block as it
    is."""
    return _inverse(a, "batched_chol_linv", "chol_linv",
                    batched_chol_linv_plain, CHOL_P_MAX)


# --- K2: fused shared-basis ADMM -----------------------------------------

def fused_admm_shared_plain(a0, a1, minv, mu, d, e, qs, ls, us, rho_vec,
                            x0, y0, z0, *, iters: int, sigma: float,
                            alpha: float):
    """``iters`` scaled-space ADMM iterations with A_s = diag(e)(A0 +
    mu A1)diag(d); the x-update reduces over minv's rows."""
    me = mu[:, None] * e
    inv_rho = 1.0 / rho_vec
    x, y, z = x0, y0, z0
    for _ in range(iters):
        w = rho_vec * z - y
        atw = (e * w) @ a0 + (me * w) @ a1
        rhs = sigma * x - qs + d * atw
        xt = torch.einsum("bij,bi->bj", minv, rhs)
        x1 = alpha * xt + (1.0 - alpha) * x
        xd = d * xt
        ax = e * (xd @ a0.T) + me * (xd @ a1.T)
        zp = alpha * ax + (1.0 - alpha) * z
        z1 = torch.clamp(zp + y * inv_rho, ls, us)
        y = y + rho_vec * (zp - z1)
        x, z = x1, z1
    return x, y, z


def fused_admm_shared_smem_bytes(n: int, m: int) -> int:
    """Shared memory a block of ``csrc/fused_admm_shared.cu`` needs besides
    its padded lists (``fixed_bytes`` there): the right-hand side as
    doubles, padded to the register tier's width (68 or 120 at n <= 120;
    past it minv's n x n in shared memory too), d xt and nine row
    vectors."""
    tier = next((t for t in (68, 120) if n <= t), 0)
    rpad = tier or -(-n // 4) * 4
    return 4 * (2 * rpad + (0 if tier else n * n) + n + 9 * m)


def fused_admm_shared_occupancy(n: int, m: int) -> dict:
    """The main kernel of csrc/fused_admm_shared.cu that n selects (the
    register tiers at n <= 68 and n <= 120, the shared-memory tier past
    it), at (n, m)'s shared memory: its resident blocks (scenarios) an SM
    by CUDA's occupancy calculator, its registers and its local memory
    (spill) bytes a thread."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    fn = _fn("fused_admm_shared", "occupancy", [ctypes.c_int] * 2 + [_P] * 2)
    blocks = fn(n, m, ctypes.addressof(regs), ctypes.addressof(local))
    if blocks < 0:
        raise RuntimeError(f"fused_admm_shared occupancy at n={n}, m={m}: "
                           f"CUDA error {-blocks}")
    return dict(blocks=blocks, registers=regs.value,
                local_bytes=local.value)


def fused_admm_shared(a0, a1, minv, mu, d, e, qs, ls, us, rho_vec, x0, y0,
                      z0, *, iters: int, sigma: float = 1e-6,
                      alpha: float = 1.6):
    """Batched fixed-iteration ADMM in the scaled space through the CUDA
    kernel (csrc/fused_admm_shared.cu): a0/a1 (m, n) shared, any values
    (their nonzeros are packed on the card by a first launch); minv
    (B, n, n) symmetric scaled-KKT inverse; mu (B,); d, qs, x0 (B, n);
    e, ls, us, rho_vec, y0, z0 (B, m). Returns scaled (x, y, z). Plain
    version on the CPU."""
    b, n = qs.shape
    m = ls.shape[1]
    if not _on_card(qs):
        return fused_admm_shared_plain(a0, a1, minv, mu, d, e, qs, ls, us,
                                       rho_vec, x0, y0, z0, iters=iters,
                                       sigma=sigma, alpha=alpha)
    dev = qs.device
    for name, t, shape in (
            ("a0", a0, (m, n)), ("a1", a1, (m, n)), ("minv", minv, (b, n, n)),
            ("mu", mu, (b,)), ("d", d, (b, n)), ("e", e, (b, m)),
            ("qs", qs, (b, n)), ("ls", ls, (b, m)), ("us", us, (b, m)),
            ("rho_vec", rho_vec, (b, m)), ("x0", x0, (b, n)),
            ("y0", y0, (b, m)), ("z0", z0, (b, m))):
        _check(name, t, shape, dev)
    if fused_admm_shared_smem_bytes(n, m) > MAX_SMEM_BYTES:
        raise ValueError(f"fused_admm_shared: n={n}, m={m} exceed shared "
                         "memory")
    x = torch.empty_like(qs)
    y = torch.empty_like(ls)
    z = torch.empty_like(ls)
    # the pack launch's output (struct Packed): 4 n m strided and 4 nl
    # padded (index, value) pairs and nl counts, nl = 2 (n + m) lists
    nl = 2 * (n + m)
    scratch = torch.empty(8 * n * m + 9 * nl, dtype=torch.float32,
                          device=dev)
    ptrs = [t.data_ptr() for t in (a0, a1, minv, mu, d, e, qs, ls, us,
                                   rho_vec, x0, y0, z0, x, y, z, scratch)]
    rc = _fn("fused_admm_shared")(
        *ptrs, b, n, m, int(iters), float(sigma), float(alpha),
        float(1.0 - alpha), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_admm_shared launch failed: CUDA error "
                           f"{rc}")
    launches["fused_admm_shared"] += 1
    return x, y, z


# --- K4: fused ADMM, per-scenario A -------------------------------------

def fused_admm_plain(minv, a_s, qs, ls, us, rho_vec, x0, y0, z0, *,
                     iters: int, sigma: float, alpha: float,
                     reciprocal: bool = True):
    """``iters`` scaled-space ADMM iterations with a per-scenario A_s;
    the x-update reduces along minv's rows (minv @ rhs). The z-update
    multiplies y by 1/rho (the kernel's order) or, with ``reciprocal``
    off, divides it by rho (the order of ``qp.admm_solve``)."""
    inv_rho = 1.0 / rho_vec
    x, y, z = x0, y0, z0
    for _ in range(iters):
        w = rho_vec * z - y
        rhs = sigma * x - qs + torch.einsum("bmn,bm->bn", a_s, w)
        xt = torch.einsum("bij,bj->bi", minv, rhs)
        x1 = alpha * xt + (1.0 - alpha) * x
        ax = torch.einsum("bmn,bn->bm", a_s, xt)
        zp = alpha * ax + (1.0 - alpha) * z
        z1 = torch.clamp(zp + (y * inv_rho if reciprocal else y / rho_vec),
                         ls, us)
        y = y + rho_vec * (zp - z1)
        x, z = x1, z1
    return x, y, z


def fused_admm_smem_bytes(n: int, m: int) -> int:
    """Shared memory a block of ``csrc/fused_admm.cu`` needs without its
    nonzero lists (``Layout`` there): the right-hand side (padded to 128
    at n <= 128; past it minv's n x n in shared memory too), xt with its
    +0 sentinel, (x, q) a column and (y, z, l, u, rho, w) a row, one more
    row for the sentinel; each part padded to 4 floats."""
    r4 = lambda v: -(-v // 4) * 4
    reg = n <= 128
    return 4 * ((0 if reg else r4(n * n)) + (128 if reg else r4(n))
                + r4(n + 1) + r4(2 * n) + 6 * (m + 1))


def fused_admm(minv, a_s, qs, ls, us, rho_vec, x0, y0, z0, *, iters: int,
               sigma: float = 1e-6, alpha: float = 1.6):
    """Batched fixed-iteration ADMM in the scaled space through the CUDA
    kernel (csrc/fused_admm.cu): minv (B, n, n) scaled-KKT inverse (not
    assumed symmetric); a_s (B, m, n) scaled constraint matrix, any values
    (each block packs its nonzeros on the card; one whose A does not fit
    the friction pyramid's list widths runs the dense order, and says so
    in ``paths["fused_admm"]``); qs, x0 (B, n); ls, us, rho_vec, y0, z0
    (B, m). Returns scaled (x, y, z). Plain version on the CPU."""
    b, n = qs.shape
    m = ls.shape[1]
    if not _on_card(qs):
        return fused_admm_plain(minv, a_s, qs, ls, us, rho_vec, x0, y0, z0,
                                iters=iters, sigma=sigma, alpha=alpha)
    dev = qs.device
    for name, t, shape in (
            ("minv", minv, (b, n, n)), ("a_s", a_s, (b, m, n)),
            ("qs", qs, (b, n)), ("ls", ls, (b, m)), ("us", us, (b, m)),
            ("rho_vec", rho_vec, (b, m)), ("x0", x0, (b, n)),
            ("y0", y0, (b, m)), ("z0", z0, (b, m))):
        _check(name, t, shape, dev)
    if fused_admm_smem_bytes(n, m) > MAX_SMEM_BYTES:
        raise ValueError(f"fused_admm: n={n}, m={m} exceed shared memory")
    x = torch.empty_like(qs)
    y = torch.empty_like(ls)
    z = torch.empty_like(ls)
    dense = torch.empty(b, dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (minv, a_s, qs, ls, us, rho_vec, x0, y0,
                                   z0, x, y, z, dense)]
    rc = _fn("fused_admm")(
        *ptrs, b, n, m, int(iters), float(sigma), float(alpha),
        float(1.0 - alpha), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_admm launch failed: CUDA error {rc}")
    launches["fused_admm"] += 1
    paths["fused_admm"] = dense
    return x, y, z
