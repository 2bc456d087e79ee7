"""Batched SPD linear algebra (counterpart of ``ops/linalg.py``).

- ``spd_inverse``/``spd_solve``, for the EKF innovation: Jacobi
  equilibration, then recursive Schur-complement block inversion down to
  unrolled pivot-free Gauss-Jordan bases. Valid for EKF-class matrices
  whose conditioning comes from diagonal scale.
- ``spd_cholesky_inverse``, the 'chol' route's KKT inverse: blocked
  right-looking Cholesky, block triangular inverse and M'M, as sequential
  masked panel steps and batched products (the JAX package leaves all of
  it to XLA, so it is plain PyTorch here too). Its sibling
  ``spd_cholesky_inverse_hybrid`` does each panel's Cholesky and
  triangular inverse in the K5 kernel (``ops/kernels.batched_chol_linv``).

Every product is exact float32 (the package turns TF32 off on import).
"""

from __future__ import annotations

import torch

from a1_qp_mpc_controller_tpu_torch.ops.kernels import batched_chol_linv


def gj_inverse_unrolled(m: torch.Tensor) -> torch.Tensor:
    """Pivot-free Gauss-Jordan inverse over the last two axes (small n)."""
    n = m.shape[-1]
    inv = torch.eye(n, dtype=m.dtype, device=m.device).expand(m.shape)
    keep = torch.ones((n, 1), dtype=m.dtype, device=m.device)
    for k in range(n):
        inv_d = 1.0 / m[..., k:k + 1, k:k + 1]
        row_m = m[..., k:k + 1, :] * inv_d
        row_i = inv[..., k:k + 1, :] * inv_d
        keep_k = keep.clone()
        keep_k[k] = 0.0
        factor = m[..., :, k:k + 1] * keep_k
        m = m - factor * row_m
        inv = inv - factor * row_i
        m = torch.cat([m[..., :k, :], row_m, m[..., k + 1:, :]], dim=-2)
        inv = torch.cat([inv[..., :k, :], row_i, inv[..., k + 1:, :]],
                        dim=-2)
    return inv


def _schur_inverse(x: torch.Tensor, base: int) -> torch.Tensor:
    k = x.shape[-1]
    if k <= base:
        return gj_inverse_unrolled(x)
    h = k // 2
    a, b, c = x[..., :h, :h], x[..., :h, h:], x[..., h:, h:]
    ai = _schur_inverse(a, base)
    w = ai @ b
    s = c - b.transpose(-1, -2) @ w
    si = _schur_inverse(s, base)
    tr = -(w @ si)
    tl = ai - tr @ w.transpose(-1, -2)
    top = torch.cat([tl, tr], dim=-1)
    bot = torch.cat([tr.transpose(-1, -2), si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def spd_inverse(m: torch.Tensor, base: int = 8) -> torch.Tensor:
    """Inverse of SPD matrices (..., n, n), Jacobi-equilibrated and
    symmetrized."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(m, dim1=-2, dim2=-1),
                                min=1e-30))
    dd = d[..., :, None] * d[..., None, :]
    out = _schur_inverse(m * dd, base)
    out = 0.5 * (out + out.transpose(-1, -2))
    return out * dd


def spd_solve(m: torch.Tensor, rhs: torch.Tensor, base: int = 8
              ) -> torch.Tensor:
    """Solve M X = RHS for SPD M (..., n, n), RHS (..., n, k) or (..., n)."""
    minv = spd_inverse(m, base)
    if rhs.ndim == m.ndim - 1:
        return torch.einsum("...ij,...j->...i", minv, rhs)
    return minv @ rhs


def _chol_unblocked(a: torch.Tensor, r: int) -> torch.Tensor:
    """Batched dense Cholesky of (B, r, r) SPD -> lower L, by r sequential
    outer-product steps on the trailing block."""
    a = a.clone()
    for k in range(r):
        ck = a[:, :, k].clone()                              # (B, r)
        akk = torch.clamp(ck[:, k:k + 1], min=1e-30)         # (B, 1)
        sq = torch.sqrt(akk)
        tail = ck[:, k + 1:]
        a[:, k + 1:, k + 1:] -= (tail / akk)[:, :, None] * tail[:, None, :]
        a[:, k, k] = sq[:, 0]
        a[:, k + 1:, k] = tail / sq
    return torch.tril(a)


def _tri_lower_inv(lo: torch.Tensor, r: int) -> torch.Tensor:
    """Batched inverse of lower-triangular (B, r, r) by forward
    substitution over rows."""
    x = torch.zeros_like(lo)
    eye = torch.eye(r, dtype=lo.dtype, device=lo.device)
    for k in range(r):
        s = lo[:, k:k + 1, :k] @ x[:, :k, :]                 # (B, 1, r)
        x[:, k:k + 1, :] = (eye[k] - s) / lo[:, k:k + 1, k:k + 1]
    return x


def pad_identity(m: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(B, n, n) -> (B, n_pad, n_pad) with an identity tail: zero coupling,
    so the padded inverse's top-left block is the inverse."""
    b, n, _ = m.shape
    mm = torch.eye(n_pad, dtype=m.dtype, device=m.device).repeat(b, 1, 1)
    mm[:, :n, :n] = m
    return mm


def _blocked_cholesky_inverse(k_mat: torch.Tensor, panel: int,
                              panel_linv) -> torch.Tensor:
    """The blocked Cholesky inverse, with ``panel_linv(a11)`` giving
    L11^-1 of each diagonal panel (A11 = L11 L11'). n is padded with an
    identity tail up to a multiple of ``panel``."""
    b, n, _ = k_mat.shape
    if n % panel != 0:
        n_pad = -(-n // panel) * panel
        out = _blocked_cholesky_inverse(pad_identity(k_mat, n_pad), panel,
                                        panel_linv)
        return out[:, :n, :n].contiguous()
    np_ = n // panel
    a = k_mat.clone()
    lfull = torch.zeros_like(k_mat)
    linv_diag = []
    for pi in range(np_):
        p0, p1 = pi * panel, (pi + 1) * panel
        l11inv = panel_linv(a[:, p0:p1, p0:p1])
        linv_diag.append(l11inv)
        if p1 < n:
            l21 = a[:, p1:, p0:p1] @ l11inv.transpose(1, 2)  # A21 L11^-T
            lfull[:, p1:, p0:p1] = l21
            a[:, p1:, p1:] -= l21 @ l21.transpose(1, 2)

    # block lower-triangular inverse: M_ii = L_ii^-1;
    # M_ij = -L_ii^-1 (sum_{j<=k<i} L_ik M_kj)   for i > j
    mfull = torch.zeros_like(k_mat)
    for pi in range(np_):
        p0, p1 = pi * panel, (pi + 1) * panel
        mfull[:, p0:p1, p0:p1] = linv_diag[pi]
    for pi in range(1, np_):
        p0, p1 = pi * panel, (pi + 1) * panel
        for pj in range(pi):
            q0, q1 = pj * panel, (pj + 1) * panel
            acc = sum(lfull[:, p0:p1, pk * panel:(pk + 1) * panel]
                      @ mfull[:, pk * panel:(pk + 1) * panel, q0:q1]
                      for pk in range(pj, pi))
            mfull[:, p0:p1, q0:q1] = -(linv_diag[pi] @ acc)

    # X = L^-T L^-1 = M' M
    return mfull.transpose(1, 2) @ mfull


def spd_cholesky_inverse(k_mat: torch.Tensor, panel: int = 30
                         ) -> torch.Tensor:
    """Inverse of SPD matrices (B, n, n) via blocked Cholesky: panel
    Cholesky and triangular panel inverse as sequential masked steps,
    trailing updates, the block triangular inverse and M'M as batched
    products."""
    return _blocked_cholesky_inverse(
        k_mat, panel, lambda a11: _tri_lower_inv(_chol_unblocked(a11, panel),
                                                 panel))


def spd_cholesky_inverse_hybrid(k_mat: torch.Tensor, panel: int = 30
                                ) -> torch.Tensor:
    """:func:`spd_cholesky_inverse` with each panel's Cholesky and
    triangular inverse in the K5 kernel (``batched_chol_linv``; its plain
    version on the CPU) and everything else as batched products."""
    return _blocked_cholesky_inverse(
        k_mat, panel, lambda a11: batched_chol_linv(a11.contiguous()))
