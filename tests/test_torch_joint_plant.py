"""The 18-DoF articulated plant (``sim/joint_plant.py``) of the port
against the JAX module, on the CPU.

- ``_substep``, ``plant_step`` (10 substeps), ``init_standing`` and
  ``read_sensors`` on B = 16 seeded states carried across as NumPy arrays
  (standing with perturbed joints and velocities, feet in swing above the
  ground, the robot in flight, feet just touching down), the JAX module
  under ``jit`` and ``vmap``: in float64 (``jax.enable_x64``) every field
  within ``F64_TOL`` and the contact flags exactly; in float32 pose and
  velocities within ``F32_ATOL`` plus ``F32_RTOL`` of the field's
  largest magnitude and the normal forces within ``FORCE_TOL``, the flags
  exactly.
- The plant's closed-form leg derivatives against ``torch.func``'s.
- Each contact transition on states placed on both sides of its
  threshold: touchdown (foot height 1e-4 m below or above the ground,
  vertical velocity negative, zero or positive) and release (a lifting
  torque 5% past or short of the one that takes the normal force to 0).
- The physics of ``tests/test_joint_plant.py`` on the port: free fall,
  torque saturation, standing equilibrium, the sensors at rest.
- Under ``slow``: its closed-loop tests (stand on three profiles, the
  trot, the Isaac walk onset) through the port's ``rollout(plant=)``,
  under the JAX tests' assertions on the port's own trajectory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a1_qp_mpc_controller_tpu.config import load_profile as jload
from a1_qp_mpc_controller_tpu.sim import joint_plant as jjp
from a1_qp_mpc_controller_tpu.sim import terrain as jtr
from a1_qp_mpc_controller_tpu_torch import convert
from a1_qp_mpc_controller_tpu_torch.config import load_profile as tload
from a1_qp_mpc_controller_tpu_torch.models import kinematics as tkin
from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb
from a1_qp_mpc_controller_tpu_torch.sim import closed_loop as tcl
from a1_qp_mpc_controller_tpu_torch.sim import joint_plant as tjp
from a1_qp_mpc_controller_tpu_torch.sim import terrain as ttr
from a1_qp_mpc_controller_tpu_torch.tensors import broadcast_batch, tree_map
from a1_qp_mpc_controller_tpu_torch.utils import mathx as tmathx

from torch_parity import CPU, jax_to_dict

B = 16
DT = 0.0025
SUBSTEPS = 10
# float64: both packages' arithmetic agrees to ~1e-13 on every field but
# the normal forces (~6e-12 N: LAPACK's solve of the 30 x 30 KKT with its
# 1e-8 dual diagonal), so a limit of 1e-9 holds with room
F64_TOL = 1e-9
# float32, relative to each field's largest magnitude: the velocities come
# out of a 30 x 30 solve whose rounding scales with the largest of them,
# not with each entry (measured: joint velocities 1.1e-4 rad/s apart where
# the largest is ~14, forces 3.4e-3 N after 10 substeps, each package's
# float32 rounding of the same solve; the card against the CPU at
# B = 1024, chip_smoke.py phase 6h: 3.7e-5 rad/s, 7.7e-3 N)
F32_RTOL, F32_ATOL = 1e-4, 1e-5
FORCE_TOL = 1e-2     # N
POSE = ("root_pos", "root_quat", "joint_pos", "foot_pos", "pin_anchor")
VELOCITY = ("root_lin_vel", "root_ang_vel", "joint_vel", "foot_vel")
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


# ---------------------------------------------------------------- helpers


@pytest.fixture(scope="module")
def jparams():
    return jload("gazebo_mpc")[1]


@pytest.fixture(scope="module")
def tparams():
    return tload("gazebo_mpc", device=CPU)[1]


def _euler_quat(rpy):
    h = rpy / 2
    cr, sr = np.cos(h[:, 0]), np.sin(h[:, 0])
    cp, sp = np.cos(h[:, 1]), np.sin(h[:, 1])
    cy, sy = np.cos(h[:, 2]), np.sin(h[:, 2])
    return np.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy],
                    axis=-1)


def _standing(jparams) -> dict:
    """The JAX standing state tiled to B, as float64 NumPy arrays."""
    ps = jjp.init_standing(jparams, jtr.Terrain.flat(), 0.3)
    return {k: np.repeat(v[None], B, 0).astype(
                np.float64 if v.dtype.kind == "f" else v.dtype)
            for k, v in jax_to_dict(ps).items()}


def _feet_world(s: dict, tparams) -> np.ndarray:
    """The plant's foot points (rho_opt = 0), world frame, (B, 4, 3)."""
    q = torch.tensor(s["joint_pos"]).reshape(B, 4, 3)
    rel = tkin.fk(q, torch.zeros(3, dtype=q.dtype), tparams.rho_fix.double())
    rot = tmathx.quat_to_rot(torch.tensor(s["root_quat"]))
    return (torch.tensor(s["root_pos"])[:, None, :]
            + torch.einsum("bij,blj->bli", rot, rel)).numpy()


def _seeded_states(jparams, tparams) -> dict:
    """Four groups of four: standing with perturbed joints and velocities,
    the pins at the perturbed feet (0-3); legs 0 and 3 in swing, their
    knees flexed 0.4 rad (4-7); every leg free, the body 0.1 m up (8-11);
    legs 1 and 2 free, their knees extended to put the feet below the
    ground, the body falling at 0.1 m/s (12-15)."""
    rng = np.random.default_rng(1)
    s = _standing(jparams)
    s["joint_pos"] = s["joint_pos"] + rng.normal(0, 0.03, (B, 12))
    s["joint_vel"] = rng.normal(0, 0.2, (B, 12))
    s["root_lin_vel"] = rng.normal(0, 0.05, (B, 3))
    s["root_ang_vel"] = rng.normal(0, 0.1, (B, 3))
    s["root_quat"] = _euler_quat(rng.normal(0, 0.03, (B, 3)))
    for leg in (0, 3):
        s["joint_pos"][4:8, 3 * leg + 2] -= 0.4
        s["in_contact"][4:8, leg] = False
    s["in_contact"][8:12] = False
    s["root_pos"][8:12, 2] += 0.1
    for leg in (1, 2):
        s["joint_pos"][12:16, 3 * leg + 2] += 0.06
        s["in_contact"][12:16, leg] = False
    s["root_lin_vel"][12:16, 2] = -0.1
    s["pin_anchor"] = np.where(s["in_contact"][..., None],
                               _feet_world(s, tparams), s["pin_anchor"])
    return s


def _cast(d: dict, np_dtype) -> dict:
    return {k: v.astype(np_dtype) if v.dtype.kind == "f" else v
            for k, v in d.items()}


def _batched_params(jparams, tparams, np_dtype, t_dtype):
    pj = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(np.asarray(a).astype(
            np_dtype) if np.asarray(a).dtype.kind == "f" else a),
            (B,) + np.shape(a)), jparams)
    pt = tree_map(lambda a: a.to(t_dtype) if a.is_floating_point() else a,
                  broadcast_batch(tparams, B))
    return pj, pt


def _flat(np_dtype, t_dtype):
    tj = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(a, np_dtype), (B,)),
        jtr.Terrain.flat())
    return tj, ttr.Terrain.flat(B, dtype=t_dtype, device=CPU)


# one compile a step and dtype: the jitted functions take dt as an argument
_JAX_STEPS = {
    "substep": jax.jit(jax.vmap(
        lambda p, t, s, q, dt: jjp._substep(p, t, s, q, dt / SUBSTEPS),
        in_axes=(0, 0, 0, 0, None))),
    "plant_step": jax.jit(jax.vmap(
        lambda p, t, s, q, dt: jjp.plant_step(p, t, s, q, dt, SUBSTEPS),
        in_axes=(0, 0, 0, 0, None))),
}


def _run_both(name, jparams, tparams, states: dict, tau, dtype):
    """``_substep`` or ``plant_step`` of both packages from ``states``;
    returns (port, JAX) states as dicts of arrays."""
    np_dtype, t_dtype = DTYPES[dtype]
    with jax.enable_x64(dtype == "float64"):
        pj, pt = _batched_params(jparams, tparams, np_dtype, t_dtype)
        tj, tt = _flat(np_dtype, t_dtype)
        st = _cast(states, np_dtype)
        sj = jjp.JointPlantState(**{k: jnp.asarray(v) for k, v in st.items()})
        out_j = jax_to_dict(_JAX_STEPS[name](
            pj, tj, sj, jnp.asarray(tau.astype(np_dtype)),
            jnp.asarray(DT, np_dtype)))
    ps = convert.from_numpy(tjp.JointPlantState, st, CPU, t_dtype)
    tq = torch.tensor(tau.astype(np_dtype))
    dt_t = torch.tensor(DT, dtype=t_dtype)
    if name == "substep":
        out_t, info = tjp._substep(pt, tt, ps, tq, dt_t / SUBSTEPS)
        assert not info.any()
    else:
        out_t = tjp.plant_step(pt, tt, ps, tq, dt_t, SUBSTEPS)
    return convert.to_numpy(out_t), out_j


def _assert_fields(port: dict, ref: dict, dtype, what):
    assert port.keys() == ref.keys()
    for k in ref:
        msg = f"{what} {dtype} {k}"
        if ref[k].dtype == bool:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=msg)
        elif dtype == "float64":
            np.testing.assert_allclose(port[k], ref[k], rtol=0,
                                       atol=F64_TOL, err_msg=msg)
        elif k == "foot_force_n":
            np.testing.assert_allclose(port[k], ref[k], rtol=0,
                                       atol=FORCE_TOL, err_msg=msg)
        else:
            assert k in POSE + VELOCITY, k
            np.testing.assert_allclose(
                port[k], ref[k], rtol=0,
                atol=F32_ATOL + F32_RTOL * np.abs(ref[k]).max(), err_msg=msg)


# ---------------------------------------------------------------- parity


def _leg_kin_func(q, qd, rho_fix):
    """One leg's ``_leg_kin`` terms by ``torch.func``, as the JAX module
    takes them with ``jax.jacfwd`` / ``jax.jvp``."""
    com_of = lambda qq: tjp._leg_links(qq, rho_fix)[0]
    tri = torch.tril(torch.ones(3, 3, dtype=q.dtype))

    def vel_quants(qq):
        a = tjp._leg_links(qq, rho_fix)[2]
        cdot = torch.einsum("laj,j->la", torch.func.jacfwd(com_of)(qq), qd)
        om = torch.einsum("lja,j->la", a[None] * tri[:, :, None], qd)
        return cdot, om

    (cdot, _), (cddot0, omdot0) = torch.func.jvp(vel_quants, (q,), (qd,))
    zero = torch.zeros_like(q)
    pdot_f, pddot0_f = torch.func.jvp(
        lambda qq: tkin.jac(qq, zero, rho_fix) @ qd, (q,), (qd,))
    return dict(dcom_dq=torch.func.jacfwd(com_of)(q), cdot=cdot,
                cddot0=cddot0, omdot0=omdot0, pdot_f=pdot_f,
                pddot0_f=pddot0_f)


def test_leg_kin_closed_forms_match_torch_func(tparams):
    """The plant's closed-form joint derivatives and bias accelerations
    against ``torch.func`` (jacfwd, jvp of jacfwd, under vmap) of the
    link chain, float64, over random poses and rates of the four legs."""
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.uniform(-1.0, 1.0, (8, 4, 3)))
    qd = torch.tensor(rng.normal(0.0, 3.0, (8, 4, 3)))
    rho = tparams.rho_fix.double().expand(8, 4, 5)
    got = tjp._leg_kin(q, qd, rho)
    ref = torch.func.vmap(_leg_kin_func)(
        q.reshape(-1, 3), qd.reshape(-1, 3), rho.reshape(-1, 5))
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].reshape(v.shape).numpy(),
                                   v.numpy(), rtol=0, atol=1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", ["substep", "plant_step"])
def test_step_matches_jax(jparams, tparams, name, dtype):
    states = _seeded_states(jparams, tparams)
    tau = np.random.default_rng(2).normal(0, 1.0, (B, 12))
    port, ref = _run_both(name, jparams, tparams, states, tau, dtype)
    _assert_fields(port, ref, dtype, name)
    # the states cross both transitions: falling feet touched down, pinned
    # feet released; the flying robot stayed free
    assert ref["in_contact"][12:16][:, [1, 2]].any()
    assert (states["in_contact"] & ~ref["in_contact"]).any()
    assert not ref["in_contact"][8:12].any()


def test_init_standing_matches_jax(jparams, tparams):
    """On flat, sloped and stepped ground (``randomize_terrain``'s
    draws)."""
    tt = tb.randomize_terrain(torch.Generator().manual_seed(3), B,
                              device=CPU)
    tt = tt.replace(slope_start=torch.full((B,), -1.0),
                    stairs_start=torch.full((B,), -0.1))
    tj = jtr.Terrain(**{k: jnp.asarray(v) for k, v in
                        convert.to_numpy(tt).items()})
    ref = jax_to_dict(jax.jit(jax.vmap(
        lambda t: jjp.init_standing(jparams, t, 0.32)))(tj))
    port = convert.to_numpy(tjp.init_standing(
        broadcast_batch(tparams, B), tt, 0.32, device=CPU))
    _assert_fields(port, ref, "float32", "init_standing")
    assert np.ptp(ref["root_pos"][:, 2]) > 0.01     # the ground varied


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_read_sensors_matches_jax(jparams, tparams, dtype):
    np_dtype, t_dtype = DTYPES[dtype]
    st = _cast(_seeded_states(jparams, tparams), np_dtype)
    prev = np.random.default_rng(4).normal(0, 0.1, (B, 3)).astype(np_dtype)
    with jax.enable_x64(dtype == "float64"):
        pj, pt = _batched_params(jparams, tparams, np_dtype, t_dtype)
        sj = jjp.JointPlantState(**{k: jnp.asarray(v) for k, v in st.items()})
        ref = jax_to_dict(jax.jit(jax.vmap(
            lambda p, s, v: jjp.read_sensors(p, s, v, jnp.asarray(
                DT, np_dtype))))(pj, sj, jnp.asarray(prev)))
    port = convert.to_numpy(tjp.read_sensors(
        pt, convert.from_numpy(tjp.JointPlantState, st, CPU, t_dtype),
        torch.tensor(prev), torch.tensor(DT, dtype=t_dtype)))
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(
            port[k], ref[k], rtol=0, atol=F64_TOL if dtype == "float64"
            else F32_ATOL + F32_RTOL * np.abs(ref[k]).max(), err_msg=k)


# ----------------------------------------------------------- transitions


def _touchdown_states(jparams, tparams) -> tuple[dict, np.ndarray]:
    """Every leg free, the body still; in scenario 4 * leg + case only
    ``leg``'s foot is near the ground (the others' knees flexed 0.5 rad):
    1e-4 m below it falling at 0.05 m/s (touches down), above it falling
    (does not), below it rising (does not), below it at rest (touches
    down: the test is v_z <= 0). Returns the states and the expected
    touchdown of each (B, 4)."""
    s = _standing(jparams)
    s["in_contact"][:] = False
    expect = np.zeros((B, 4), bool)
    cases = ((-1e-4, -0.05, True), (1e-4, -0.05, False),
             (-1e-4, 0.05, False), (-1e-4, 0.0, True))
    for leg in range(4):
        for c, (dz, vz, touch) in enumerate(cases):
            i = 4 * leg + c
            for other in set(range(4)) - {leg}:
                s["joint_pos"][i, 3 * other + 2] -= 0.5
            s["root_lin_vel"][i, 2] = vz
            expect[i, leg] = touch
    # the foot of the leg near the ground, through the plant's own chain
    # (rho_opt = 0, the body level)
    q = torch.tensor(s["joint_pos"]).reshape(B, 4, 3)
    z = tkin.fk(q, torch.zeros(3, dtype=q.dtype),
                tparams.rho_fix.double())[..., 2].numpy()
    for leg in range(4):
        for c, (dz, _, _) in enumerate(cases):
            i = 4 * leg + c
            s["root_pos"][i, 2] = dz - z[i, leg]
    return s, expect


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_touchdown_on_both_sides_of_its_threshold(jparams, tparams, dtype):
    s, expect = _touchdown_states(jparams, tparams)
    port, ref = _run_both("substep", jparams, tparams, s, np.zeros((B, 12)),
                          dtype)
    np.testing.assert_array_equal(ref["in_contact"], expect)
    np.testing.assert_array_equal(port["in_contact"], expect)
    _assert_fields(port, ref, dtype, "touchdown")


def _lift_torques(tparams, s, leg, scale):
    """The stance map's torques (tau = J' (-F), F = a quarter of the
    weight up at every foot) with ``leg``'s foot also pulled up by
    ``scale`` N (body frame ~ world here)."""
    q = torch.tensor(s["joint_pos"][0]).reshape(4, 3)
    j = tkin.jac(q, tparams.rho_opt.double(), tparams.rho_fix.double())
    f = torch.zeros(4, 3, dtype=q.dtype)
    f[:, 2] = -float(tparams.robot_mass) * 9.81 / 4.0
    f[leg, 2] += scale
    return torch.einsum("lba,lb->la", j, f).reshape(12).numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_release_on_both_sides_of_its_threshold(jparams, tparams, dtype):
    """Standing under the stance map's torques, one leg's foot pulled up
    5% short of and 5% past the load that takes its normal force to 0
    (the force is linear in the torque; that load is found on the port
    in float64 from two loads)."""
    s = _standing(jparams)
    pt64 = tree_map(lambda a: a.double() if a.is_floating_point() else a,
                    broadcast_batch(tparams, 1))
    ps = convert.from_numpy(tjp.JointPlantState,
                            {k: v[:1] for k, v in s.items()}, CPU,
                            torch.float64)
    terr = ttr.Terrain.flat(1, dtype=torch.float64, device=CPU)
    dt = torch.tensor(DT / SUBSTEPS, dtype=torch.float64)

    def force(leg, scale):
        tau = torch.tensor(_lift_torques(tparams, s, leg, scale))[None]
        out, _ = tjp._substep(pt64, terr, ps, tau, dt)
        assert out.in_contact[0, leg]
        return float(out.foot_force_n[0, leg])

    tau = np.stack([_lift_torques(tparams, s, 0, 0.0)] * B)
    expect = np.ones((B, 4), bool)
    for leg in range(4):
        f0, f1 = force(leg, 0.0), force(leg, 10.0)
        zero = -f0 / ((f1 - f0) / 10.0)
        for k, (factor, released) in enumerate(((0.95, False),
                                                (1.05, True))):
            tau[2 * leg + k] = _lift_torques(tparams, s, leg, factor * zero)
            expect[2 * leg + k, leg] = not released
    port, ref = _run_both("substep", jparams, tparams, s, tau, dtype)
    np.testing.assert_array_equal(ref["in_contact"], expect)
    np.testing.assert_array_equal(port["in_contact"], expect)
    _assert_fields(port, ref, dtype, "release")


# --------------------------------------------------------------- physics


def _start(tparams, height=0.3):
    pb = broadcast_batch(tparams, 1)
    terr = ttr.Terrain.flat(1, device=CPU)
    return pb, terr, tjp.init_standing(pb, terr, height, device=CPU)


def test_free_fall_com_acceleration(tparams):
    """With no contact and zero torque the trunk follows a ballistic
    arc."""
    pb, terr, ps = _start(tparams)
    up = torch.tensor([0.0, 0.0, 5.0])
    ps = ps.replace(root_pos=ps.root_pos + up, foot_pos=ps.foot_pos + up,
                    in_contact=torch.zeros_like(ps.in_contact))
    z0, v0 = float(ps.root_pos[0, 2]), float(ps.root_lin_vel[0, 2])
    n = 40
    for _ in range(n):
        ps = tjp.plant_step(pb, terr, ps, torch.zeros(1, 12),
                            torch.tensor(DT), substeps=2)
    t = n * DT
    assert abs(float(ps.root_pos[0, 2]) - (z0 + v0 * t - 0.5 * 9.81 * t * t)
               ) < 0.01
    assert not torch.isnan(ps.root_pos).any()


def test_torque_saturation_clamps_actuation(tparams):
    pb, terr, ps0 = _start(tparams)
    a = tjp.plant_step(pb, terr, ps0, torch.full((1, 12), 1e6),
                       torch.tensor(DT), substeps=5)
    b = tjp.plant_step(pb, terr, ps0, torch.full((1, 12), tjp.TORQUE_LIMIT),
                       torch.tensor(DT), substeps=5)
    np.testing.assert_allclose(a.joint_vel.numpy(), b.joint_vel.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert not torch.isnan(a.root_pos).any()


def test_standing_equilibrium_forces(tparams):
    """Pinned standing under the stance map's gravity-compensating
    torques: the normal forces sum to about the weight, the feet stay
    put."""
    pb, terr, ps = _start(tparams)
    weight = float(tparams.robot_mass) * 9.81
    jacs = tkin.jac(ps.joint_pos.reshape(1, 4, 3), pb.rho_opt, pb.rho_fix)
    f_grf = torch.tensor([0.0, 0.0, weight / 4.0])
    tau = torch.einsum("zlba,b->zla", jacs, -f_grf).reshape(1, 12)
    feet0 = ps.foot_pos.clone()
    for _ in range(20):
        ps = tjp.plant_step(pb, terr, ps, tau, torch.tensor(DT), substeps=5)
    assert abs(float(ps.foot_force_n.sum()) - weight) / weight < 0.12
    np.testing.assert_allclose(ps.foot_pos.numpy(), feet0.numpy(), atol=2e-3)
    assert abs(float(ps.root_pos[0, 2]) - 0.3) < 0.01


def test_read_sensors_shapes_and_gravity(tparams):
    pb, _, ps = _start(tparams)
    s = tjp.read_sensors(pb, ps, ps.root_lin_vel, torch.tensor(DT))
    assert s.joint_pos.shape == (1, 12)
    np.testing.assert_allclose(s.imu_acc[0].numpy(), [0.0, 0.0, 9.81],
                               atol=1e-3)


# ----------------------------------------------------------- closed loop


def _run(profile, n_steps, walk_after=None, velx=0.0, height=0.3,
         mpc_iters=400, substeps=5):
    cfg, params = tload(profile, device=CPU)
    cfg = dataclasses.replace(cfg, mpc_qp_iters=mpc_iters)
    pb = broadcast_batch(params, 1)
    terrain = ttr.Terrain.flat(1, device=CPU)
    carry = tcl.make_standing_start(cfg, pb, terrain, height=height,
                                    plant=tjp, device=CPU)
    joy = tcl.joy_schedule(n_steps, walk_after=walk_after, velx=velx,
                           device=CPU)
    return tcl.rollout(cfg, pb, terrain, carry, joy, n_steps,
                       substeps=substeps, plant=tjp, device=CPU)


@pytest.mark.slow
@pytest.mark.parametrize("profile,height",
                         [("gazebo_qp", 0.3), ("hardware_qp", 0.3),
                          ("isaac_mpc", 0.35)])
def test_stand_on_articulated_plant(profile, height):
    _, trace = _run(profile, 600, height=height, mpc_iters=120)
    rp = trace.root_pos[:, 0].numpy()
    assert not np.isnan(rp).any()
    assert np.abs(rp[-200:, 2] - height).max() < 0.05
    assert np.abs(rp[-1, :2]).max() < 0.06


@pytest.mark.slow
def test_trot_on_articulated_plant():
    _, trace = _run("gazebo_mpc", 1400, walk_after=400, velx=0.3,
                    mpc_iters=120)
    rp = trace.root_pos[:, 0].numpy()
    assert not np.isnan(rp).any()
    assert rp[-1, 0] > 0.4
    assert rp[600:, 2].min() > 0.22
    assert rp[600:, 2].max() < 0.40


@pytest.mark.slow
def test_isaac_profiles_survive_walk_onset():
    _, trace = _run("isaac_mpc", 900, walk_after=400, velx=0.2,
                    height=0.35, mpc_iters=120)
    assert not np.isnan(trace.root_pos.numpy()).any()
