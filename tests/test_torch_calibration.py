"""Calibration and its kinematic derivatives on the port against the JAX
package, on the CPU:

- ``utils/mathx.euler_to_quat``;
- ``models/kinematics.py`` ``dfk_drho``, ``dJ_dq`` and ``dJ_drho``
  (``torch.func.jacfwd`` of the closed forms against ``jax.jacfwd``),
  over legs and poses, in float32 and float64;
- ``models/calibration.py``: both estimators on the same samples;
- the two helpers nothing calls: ``ops/qp.newton_schulz_inverse`` (from a
  good seed and from the cold one) and ``models/srb.reference_kkt_inverse``
  (float64);
- the finite-difference and recovery tests of ``tests/test_kinematics.py``
  on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu.config import default_robot_params as jdefault
from a1_qp_mpc_controller_tpu.models import calibration as jcal
from a1_qp_mpc_controller_tpu.models import kinematics as jkin
from a1_qp_mpc_controller_tpu.models import srb as jsrb
from a1_qp_mpc_controller_tpu.ops import qp as jqp
from a1_qp_mpc_controller_tpu.utils import mathx as jmathx
from a1_qp_mpc_controller_tpu_torch.config import (
    default_robot_params as tdefault,
)
from a1_qp_mpc_controller_tpu_torch.models import calibration as tcal
from a1_qp_mpc_controller_tpu_torch.models import kinematics as tkin
from a1_qp_mpc_controller_tpu_torch.models import srb as tsrb
from a1_qp_mpc_controller_tpu_torch.ops import qp as tqp
from a1_qp_mpc_controller_tpu_torch.tensors import broadcast_batch, tree_map
from a1_qp_mpc_controller_tpu_torch.utils import mathx as tmathx

from torch_parity import CPU

# float32: the two packages' sin/cos and products round apart by a few
# ulp of values of order 1
F32_TOL = 2e-6
F64_TOL = 1e-12


@pytest.fixture(scope="module")
def jp():
    return jdefault()


@pytest.fixture(scope="module")
def tp():
    return tdefault(device=CPU)


def test_euler_to_quat_matches_jax():
    e = np.random.default_rng(0).uniform(-np.pi, np.pi, (64, 3))
    for dtype in (np.float32, np.float64):
        with jax.enable_x64(dtype == np.float64):
            ref = np.asarray(jmathx.euler_to_quat(jnp.asarray(e, dtype)))
        port = tmathx.euler_to_quat(torch.tensor(e.astype(dtype))).numpy()
        np.testing.assert_allclose(port, ref, rtol=0, atol=F32_TOL
                                   if dtype == np.float32 else F64_TOL)
    # and it is quat_to_rot's inverse: R = Rz Ry Rx
    q = tmathx.euler_to_quat(torch.tensor(e[:8] * 0.4))
    np.testing.assert_allclose(tmathx.quat_to_euler(q).numpy(), e[:8] * 0.4,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["dfk_drho", "dJ_dq", "dJ_drho"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_derivatives_match_jax(jp, tp, name, dtype):
    """(T = 8 poses, 4 legs), a random contact offset, row-major J[i, j]
    flattening."""
    rng = np.random.default_rng(1)
    q = rng.uniform(-1.0, 1.0, (8, 4, 3)).astype(dtype)
    rho = rng.normal(0, 0.01, (4, 3)).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        fn = getattr(jkin, name)
        ref = np.asarray(jax.vmap(jax.vmap(fn), in_axes=(0, None, None))(
            jnp.asarray(q), jnp.asarray(rho),
            jnp.asarray(np.asarray(jp.rho_fix), dtype)))
    port = getattr(tkin, name)(torch.tensor(q), torch.tensor(rho),
                               tp.rho_fix.to(torch.float64 if dtype ==
                                             np.float64 else torch.float32))
    assert port.shape == ref.shape == (8, 4) + ((3, 3) if name == "dfk_drho"
                                               else (9, 3))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=F32_TOL
                               if dtype == np.float32 else F64_TOL)


def _samples(rho_fix_j, rho_true, seed, t):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-0.6, 0.6, (t, 3)).astype(np.float32)
    qd = rng.uniform(-3.0, 3.0, (t, 3)).astype(np.float32)
    p = np.asarray(jax.vmap(lambda qq: jkin.fk(qq, rho_true, rho_fix_j))(q))
    p = p + rng.normal(0, 2e-4, p.shape).astype(np.float32)
    b = np.asarray(jax.vmap(lambda qq, dd: jkin.jac(qq, rho_true, rho_fix_j)
                            @ dd)(q, qd))
    return q, qd, p, b


def test_calibrate_foot_positions_matches_jax(jp, tp):
    rho_true = jnp.array([0.012, -0.008, 0.02], jnp.float32)
    q, _, p, _ = _samples(jp.rho_fix[0], rho_true, 0, 40)
    rho_j, rms_j = jcal.calibrate_foot_positions(q, p, jp.rho_fix[0])
    rho_t, rms_t = tcal.calibrate_foot_positions(
        torch.tensor(q), torch.tensor(p), tp.rho_fix[0])
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), atol=1e-6)
    np.testing.assert_allclose(float(rms_t), float(rms_j), rtol=1e-3)


def test_calibrate_leg_odometry_matches_jax(jp, tp):
    rho_true = jnp.array([0.01, -0.006, 0.015], jnp.float32)
    q, qd, _, b = _samples(jp.rho_fix[0], rho_true, 1, 60)
    rho_j = jcal.calibrate_leg_odometry(q, qd, b, jp.rho_fix[0])
    rho_t = tcal.calibrate_leg_odometry(torch.tensor(q), torch.tensor(qd),
                                        torch.tensor(b), tp.rho_fix[0])
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), atol=2e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_newton_schulz_inverse_matches_jax(dtype):
    """A well-conditioned SPD batch; scenario 0 seeded near its inverse,
    scenario 1 with a useless seed (restarts from the cold one), 3
    iterations."""
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1, (2, 12, 12))
    m = (a @ a.transpose(0, 2, 1) / 12 + 2 * np.eye(12)).astype(dtype)
    seed = np.stack([np.linalg.inv(m[0]) + rng.normal(0, 1e-3, (12, 12)),
                     np.zeros((12, 12))]).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = np.asarray(jax.vmap(lambda mm, ss: jqp.newton_schulz_inverse(
            mm, ss, 3))(jnp.asarray(m), jnp.asarray(seed)))
    port = tqp.newton_schulz_inverse(torch.tensor(m), torch.tensor(seed), 3)
    tol = 1e-4 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=tol)
    # the near-exact seed converged; the cold start is on its way
    eye = np.eye(12)
    assert np.abs(eye - port[0].double().numpy() @ m[0]).max() < 1e-5
    assert np.abs(eye - port[1].double().numpy() @ m[1]).max() < 1.0


def test_reference_kkt_inverse_matches_jax(jp, tp):
    """Float64: both packages' exact scaled-KKT inverse at the
    representative instance, from the JAX package's scaling."""
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)
        scal = jsrb.reference_mpc_scaling(jp64, dtype=jnp.float64)
        ref = np.asarray(jsrb.reference_kkt_inverse(
            jp64, scal, 3e-3, dtype=jnp.float64))
        scal_np = {k: np.asarray(getattr(scal, k))[None] for k in "dec"}
    tp64 = tree_map(lambda a: a.double() if a.is_floating_point() else a,
                    broadcast_batch(tp, 1))
    tscal = tqp.Scaling(**{k: torch.tensor(v) for k, v in scal_np.items()})
    port = tsrb.reference_kkt_inverse(tp64, tscal, 3e-3)
    assert port.shape == (1,) + ref.shape
    np.testing.assert_allclose(port[0].numpy(), ref, rtol=0,
                               atol=1e-9 * np.abs(ref).max())


# ----------------------------------- tests/test_kinematics.py on the port


def test_calibration_derivative_shapes(tp):
    q = torch.tensor(np.random.default_rng(0).uniform(-1.0, 1.0, 3),
                     dtype=torch.float32)
    assert tkin.dfk_drho(q, tp.rho_opt[0], tp.rho_fix[0]).shape == (3, 3)
    assert tkin.dJ_dq(q, tp.rho_opt[0], tp.rho_fix[0]).shape == (9, 3)
    assert tkin.dJ_drho(q, tp.rho_opt[0], tp.rho_fix[0]).shape == (9, 3)


def test_calibration_derivatives_match_finite_difference(tp):
    q = torch.tensor(np.random.default_rng(0).uniform(-0.8, 0.8, 3),
                     dtype=torch.float32)
    ro, rf = tp.rho_opt[0], tp.rho_fix[0]
    eps = 1e-3
    djdq = tkin.dJ_dq(q, ro, rf).numpy()
    dfk = tkin.dfk_drho(q, ro, rf).numpy()
    djr = tkin.dJ_drho(q, ro, rf).numpy()
    for k in range(3):
        d = torch.zeros(3)
        d[k] = eps
        fd = lambda f, a, b: ((f(*a) - f(*b)) / (2 * eps)).numpy()
        np.testing.assert_allclose(
            fd(tkin.jac, (q + d, ro, rf), (q - d, ro, rf)).reshape(-1),
            djdq[:, k], atol=2e-2)
        np.testing.assert_allclose(
            fd(tkin.fk, (q, ro + d, rf), (q, ro - d, rf)), dfk[:, k],
            atol=2e-2)
        np.testing.assert_allclose(
            fd(tkin.jac, (q, ro + d, rf), (q, ro - d, rf)).reshape(-1),
            djr[:, k], atol=2e-2)


def test_calibrate_foot_positions_recovers_offsets(tp):
    rho_fix = tp.rho_fix[0]
    rho_true = torch.tensor([0.012, -0.008, 0.02])
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.uniform(-0.6, 0.6, (40, 3)), dtype=torch.float32)
    p = tkin.fk(q, rho_true, rho_fix)
    p = p + torch.tensor(rng.normal(0, 2e-4, p.shape), dtype=torch.float32)
    rho_est, rms = tcal.calibrate_foot_positions(q, p, rho_fix)
    np.testing.assert_allclose(rho_est.numpy(), rho_true.numpy(), atol=2e-3)
    assert float(rms) < 1e-3


def test_calibrate_leg_odometry_recovers_offsets(tp):
    rho_fix = tp.rho_fix[0]
    rho_true = torch.tensor([0.01, -0.006, 0.015])
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.uniform(-0.6, 0.6, (60, 3)), dtype=torch.float32)
    qd = torch.tensor(rng.uniform(-3.0, 3.0, (60, 3)), dtype=torch.float32)
    b = torch.einsum("tij,tj->ti", tkin.jac(q, rho_true, rho_fix), qd)
    rho_est = tcal.calibrate_leg_odometry(q, qd, b, rho_fix)
    np.testing.assert_allclose(rho_est.numpy(), rho_true.numpy(), atol=2e-3)
