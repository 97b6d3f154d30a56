"""The port's quadruped against dojo_tpu's: Params, Topology, Schedule and
initial state (float64, 1e-12), the float32 cast, and convert round trips."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import models as jmodels
from dojo_tpu.graph import build_schedule as j_build_schedule
from dojo_tpu_torch import convert, models
from dojo_tpu_torch.core import BodyState, Params
from dojo_tpu_torch.graph import build_schedule

PARAM_FIELDS = [f.name for f in dataclasses.fields(Params)]


@pytest.fixture(scope="module")
def pair():
    jm = jmodels.get_mechanism("quadruped", timestep=0.05)
    js = jmodels.initialize(jm, "quadruped")
    tm = models.get_mechanism("quadruped", timestep=0.05, device="cpu")
    ts = models.initialize(tm, "quadruped")
    return jm, js, tm, ts


def _np(jax_tuple):
    return {f: np.asarray(getattr(jax_tuple, f)) for f in jax_tuple._fields}


@pytest.mark.parametrize("field", PARAM_FIELDS)
def test_params_match(pair, field):
    jm, _, tm, _ = pair
    ref = np.asarray(getattr(jm.params, field))
    got = getattr(tm.params, field)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)


def test_topology_matches(pair):
    jm, _, tm, _ = pair
    assert dataclasses.asdict(tm.topo) == dataclasses.asdict(jm.topo)
    assert tm.topo.dim == jm.topo.dim == 356
    assert tm.body_names == jm.body_names
    assert tm.joint_names == jm.joint_names
    assert tm.contact_names == jm.contact_names


def test_schedule_matches(pair):
    jm, _, tm, _ = pair
    ref, got = j_build_schedule(jm.topo), build_schedule(tm.topo)
    assert (got.n_nodes, got.n_slots, got.width) == (ref.n_nodes, ref.n_slots, ref.width) == (26, 100, 14)
    for f in ("node_width", "contact_offset", "joint_node", "joint_offset", "rows", "cols",
              "pad_eye", "real_diag", "vec_idx", "vec_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.slot == ref.slot and got.order == ref.order
    assert len(got.node_vars) == len(ref.node_vars)
    for a, b in zip(got.node_vars, ref.node_vars):
        np.testing.assert_array_equal(a, b)
    assert len(got.levels) == len(ref.levels) == 8
    for lg, lr in zip(got.levels, ref.levels):
        assert lg.real_w == lr.real_w
        for f in ("nodes", "upd_ai", "upd_inv", "upd_ib", "upd_tgt", "fwd_ai", "fwd_i",
                  "fwd_a", "bwd_ia", "bwd_i", "bwd_a"):
            np.testing.assert_array_equal(getattr(lg, f), getattr(lr, f), err_msg=f)


@pytest.mark.parametrize("field", ["x", "q", "v", "w"])
def test_initial_state_matches(pair, field):
    _, js, _, ts = pair
    np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
                               rtol=0, atol=1e-12)


def test_zero_state_matches(pair):
    jm, _, tm, _ = pair
    ref, got = jm.zero_state(), tm.zero_state()
    for f in ("x", "q", "v", "w"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), atol=1e-12)


def test_float32_cast_matches():
    """bench.py's configuration: cast to float32, then initialize."""
    jm = jmodels.get_mechanism("quadruped", timestep=0.05).cast(jnp.float32)
    js = jmodels.initialize(jm, "quadruped")
    tm = models.get_mechanism("quadruped", timestep=0.05, device="cpu").cast(torch.float32)
    ts = models.initialize(tm, "quadruped")
    for f in PARAM_FIELDS:
        got = getattr(tm.params, f)
        assert got.dtype == torch.float32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jm.params, f)), err_msg=f)
    # float32 forward kinematics through 13 joints: positions to a few ulps
    # of 0.43 (ulp 3e-8); velocities are finite differences over h=0.05, so
    # one ulp of position is 6e-7 of velocity
    for f, atol in (("x", 1e-6), ("q", 1e-6), ("v", 2e-6), ("w", 2e-6)):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), atol=atol)


def test_convert_params_round_trip(pair):
    jm, _, tm, _ = pair
    d = _np(jm.params)
    p = convert.params_from_numpy(d, device="cpu")
    for f in PARAM_FIELDS:
        torch.testing.assert_close(getattr(p, f), getattr(tm.params, f), rtol=0, atol=1e-12)
    back = convert.to_numpy(p)
    for f in PARAM_FIELDS:
        np.testing.assert_array_equal(back[f], d[f])
    p32 = convert.params_from_numpy(d, dtype=torch.float32, device="cpu")
    assert p32.mass.dtype == torch.float32 and p32.timestep.dtype == torch.float32


def test_convert_state_round_trip(pair):
    _, js, _, ts = pair
    d = _np(js)
    s = convert.state_from_numpy(d, device="cpu")
    assert isinstance(s, BodyState)
    for f in ("x", "q", "v", "w"):
        torch.testing.assert_close(getattr(s, f), getattr(ts, f), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(convert.to_numpy(s)[f], d[f])
    np.testing.assert_allclose(s.pack().numpy(), np.asarray(js.pack()), atol=0)
    torch.testing.assert_close(BodyState.unpack(s.pack(), 13).q, s.q, rtol=0, atol=0)


def test_convert_rejects_missing_fields(pair):
    jm, _, _, _ = pair
    d = _np(jm.params)
    del d["mass"]
    with pytest.raises(KeyError, match="mass"):
        convert.params_from_numpy(d, device="cpu")


def test_solver_options_defaults_match():
    from dojo_tpu.core import SolverOptions as JOpts
    from dojo_tpu_torch.core import SolverOptions

    assert dataclasses.asdict(SolverOptions()) == JOpts()._asdict()


def test_cone_index_sets_and_limit_activity_match(pair):
    from dojo_tpu.core import cone_index_sets as j_sets
    from dojo_tpu.core import joint_limit_activity as j_act
    from dojo_tpu_torch.core import cone_index_sets, joint_limit_activity

    jm, _, tm, _ = pair
    got, ref = cone_index_sets(tm.topo), j_sets(jm.topo)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_array_equal(joint_limit_activity(tm.topo, tm.params).numpy(),
                                  np.asarray(j_act(jm.topo, jm.params)))
