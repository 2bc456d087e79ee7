"""Helpers for the parity tests between the JAX package and its PyTorch
port: both packages get the same state, as NumPy arrays, and their
outputs are compared field by field."""

import dataclasses

import numpy as np
import torch

from a1_qp_mpc_controller_tpu_torch import convert

CPU = torch.device("cpu")

# The parity inputs are a few scenarios wide: more intra-op threads buy
# nothing and take cores from the suite's other xdist workers.
torch.set_num_threads(1)


def bench_state(cfg, seed, n, params):
    """The JAX package's ``make_bench_state`` under one ``jax.jit``: run
    eagerly, its many small vmapped ops cost ~10 s of dispatch."""
    import jax

    from a1_qp_mpc_controller_tpu.parallel.batched import make_bench_state

    return jax.jit(lambda key: make_bench_state(cfg, key, n, params))(
        jax.random.PRNGKey(seed))


def jax_to_dict(obj):
    """JAX pytree of flax structs -> nested dict of NumPy arrays."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: jax_to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None:
        return None
    return np.asarray(obj)


def to_port(cls, jax_obj):
    """The port's ``cls`` built from a JAX pytree, on the CPU."""
    return convert.from_numpy(cls, jax_to_dict(jax_obj), CPU)


def t(x, dtype=None):
    """NumPy (or JAX) array -> CPU tensor (float64 arrives as float32)."""
    arr = np.asarray(x)
    if dtype is None and arr.dtype == np.float64:
        dtype = torch.float32
    return torch.tensor(arr, dtype=dtype)


def assert_close(port, ref, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(np.asarray(port.detach().cpu()
                                          if torch.is_tensor(port) else port),
                               np.asarray(ref), atol=atol, rtol=rtol,
                               err_msg=err_msg)


def assert_tree_close(port_obj, jax_obj, atol, rtol=0.0, skip=(), path="",
                      scale_tol=0.0):
    """Compare a port tensor dataclass with the matching JAX pytree, field
    by field (exact for bool and integer fields). ``scale_tol`` adds
    ``scale_tol * max|field|`` to ``atol``, for fields whose small entries
    are differences of large ones."""
    port_d = convert.to_numpy(port_obj)
    jax_d = jax_to_dict(jax_obj)

    def walk(p, j, where):
        if isinstance(j, dict):
            diff = (set(p) ^ set(j)) - set(skip)
            assert not diff, (where, diff)
            for k in j:
                if k not in skip:
                    walk(p[k], j[k], f"{where}.{k}")
            return
        if j is None:
            assert p is None, where
            return
        assert p.shape == j.shape, (where, p.shape, j.shape)
        if j.dtype.kind in "biu":
            np.testing.assert_array_equal(p, j, err_msg=where)
        else:
            scale = float(np.nanmax(np.abs(j), initial=0.0,
                                    where=np.isfinite(j)))
            np.testing.assert_allclose(p, j, atol=atol + scale_tol * scale,
                                       rtol=rtol, err_msg=where)

    walk(port_d, jax_d, path or type(jax_obj).__name__)


# bench.py build(): the round-5 schedule
SCHEDULE = dict(mpc_qp_iters=25, mpc_solver_mode="fixed",
                mpc_cooldown_ticks=32, mpc_cooldown_stride=4,
                mpc_cooldown_dense=12, mpc_drift_rescue_n=0.5)


def to_jax(template, port_obj):
    """The JAX pytree shaped like ``template`` (arrays or
    ``jax.ShapeDtypeStruct``s) with the leaves of the port's
    ``port_obj``, matched by field path; shapes and dtypes must agree."""
    import jax
    import jax.numpy as jnp

    tree = convert.to_numpy(port_obj)

    def leaf(path, ref):
        v = tree
        for key in path:
            v = v[key.name]
        assert (v.shape, v.dtype) == (ref.shape, ref.dtype), (path, v, ref)
        return jnp.asarray(v)
    return jax.tree_util.tree_map_with_path(leaf, template)


# gait counters that keep a scenario on all four legs through the first
# trot ticks (the mixed-stance batch of tests/test_parallel.py)
ALL_STANCE = (30.0, 60.0, 60.0, 30.0)


def stood_start(b, rescue, stand_ticks=20, all_stance=()):
    """The closed-loop parity start: the port's ``make_flat_batch`` of
    ``b`` scenarios (seed 0) stood up for ``stand_ticks`` ticks on its
    'gj' route, handed to both packages, with the trot command (0.3 m/s)
    for the ticks that follow. The port stands the batch because the
    JAX package's compile of the same ticks costs ~12 s; both packages
    then start from this one state. The scenarios in ``all_stance``
    get gait counters that keep all four legs in stance while the others
    trot on two. Returns a dict: ``cfg``/``pb``/
    ``terr``/``carry``/``trot``/``dt`` for the JAX package, ``tcfg``/
    ``tpb``/``tterr``/``tcarry``/``tjoy`` for the port."""
    import jax
    import jax.numpy as jnp

    from a1_qp_mpc_controller_tpu.config import load_profile as jload
    from a1_qp_mpc_controller_tpu.parallel import batched as jb
    from a1_qp_mpc_controller_tpu.types import JoyCmd as JJoy
    from a1_qp_mpc_controller_tpu_torch import config as tcfg
    from a1_qp_mpc_controller_tpu_torch import types as tt
    from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb

    cfg, params = jload("gazebo_mpc")
    cfg = dataclasses.replace(cfg, **SCHEDULE)
    tcfg_, tparams = tcfg.load_profile("gazebo_mpc", device=CPU)
    tcfg_ = dataclasses.replace(tcfg_, **SCHEDULE)
    tpb, tterr, tcarry = tb.make_flat_batch(
        tcfg_, torch.Generator().manual_seed(0), b, tparams, device=CPU)
    stand = tt.JoyCmd.zeros(device=CPU)
    for _ in range(stand_ticks):
        tcarry = tb.batched_closed_loop_step(
            tcfg_, tpb, tterr, tcarry, stand, tcfg_.control_dt, device=CPU,
            admm_backend="pallas_shared", kkt_backend="gj", **rescue)
    if all_stance:
        gc = tcarry.cs.gait_counter.clone()
        gc[list(all_stance)] = torch.tensor(ALL_STANCE)
        tcarry = tcarry.replace(cs=tcarry.cs.replace(gait_counter=gc))
    # the JAX pytrees' structure, traced without compiling
    shapes = jax.eval_shape(lambda key: jb.make_flat_batch(
        cfg, key, b, params), jax.random.PRNGKey(0))
    pb, terr, carry = (to_jax(s, o)
                       for s, o in zip(shapes, (tpb, tterr, tcarry)))
    return dict(
        cfg=cfg, pb=pb, terr=terr, carry=carry,
        dt=jnp.float32(cfg.control_dt),
        trot=JJoy.zeros().replace(ctrl_state=jnp.int32(1),
                                  velx=jnp.float32(0.3)),
        tcfg=tcfg_, tpb=tpb, tterr=tterr, tcarry=tcarry,
        tjoy=stand.replace(ctrl_state=torch.ones((), dtype=torch.int32),
                           velx=torch.full((), 0.3)))


def trot_ticks_match(start, route, ticks=3):
    """``ticks`` trot ticks of both packages' ``batched_closed_loop_step``
    on ``route`` (the tick's keyword arguments) from ``start``, the port
    held to the JAX package after each: torques 5e-3 N m and forces
    0.05 N (float32 noise of two implementations over a few warm-carried
    ticks, the limits of tests/test_parallel.py), body position 1e-6 m,
    contacts, plan contacts and cooldown counters exactly. Returns the
    port's host reads of each tick and the contacts of each tick."""
    import jax

    from a1_qp_mpc_controller_tpu.parallel import batched as jb
    from a1_qp_mpc_controller_tpu_torch import tensors
    from a1_qp_mpc_controller_tpu_torch.parallel import batched as tb

    cfg, pb, terr = start["cfg"], start["pb"], start["terr"]
    b = start["tcarry"].ps.root_pos.shape[0]
    jstep = jax.jit(lambda c: jb.batched_closed_loop_step(
        cfg, pb, terr, c, start["trot"], start["dt"], kkt_block=b,
        admm_block=b, interpret=True, **route))
    jc, pc = start["carry"], start["tcarry"]
    reads, contacts = [], []
    for tick in range(ticks):
        jc = jstep(jc)
        before = tensors.host_syncs
        pc = tb.batched_closed_loop_step(
            start["tcfg"], start["tpb"], start["tterr"], pc, start["tjoy"],
            cfg.control_dt, device=CPU, **route)
        reads.append(tensors.host_syncs - before)
        msg = f"{route} tick {tick}"
        assert_close(pc.cs.joint_torques, jc.cs.joint_torques, atol=5e-3,
                     err_msg=msg)
        assert_close(pc.cs.foot_forces_grf, jc.cs.foot_forces_grf,
                     atol=0.05, err_msg=msg)
        assert_close(pc.ps.root_pos, jc.ps.root_pos, atol=1e-6, err_msg=msg)
        for field in ("contacts", "plan_contacts"):
            np.testing.assert_array_equal(
                getattr(pc.cs, field).numpy(),
                np.asarray(getattr(jc.cs, field)), err_msg=msg)
        np.testing.assert_array_equal(pc.mem.mpc_flip_cooldown.numpy(),
                                      np.asarray(jc.mem.mpc_flip_cooldown),
                                      err_msg=msg)
        contacts.append(np.asarray(jc.cs.contacts))
    assert np.asarray(jc.mem.mpc_flip_cooldown).max() > 0, \
        "no scenario is in the post-flip rescue window"
    return reads, contacts


def count_calls(monkeypatch, names, modules):
    """Wrap each function in ``names`` wherever one of ``modules`` binds
    it; returns {name: calls}."""
    calls = dict.fromkeys(names, 0)
    for mod in modules:
        for name in names:
            fn = getattr(mod, name, None)
            if fn is None:
                continue

            def counted(*a, _fn=fn, _name=name, **k):
                calls[_name] += 1
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, counted)
    return calls
