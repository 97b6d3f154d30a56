"""The port's zoo models against dojo_tpu's, in float64: Params, Topology
(contact kinds and geometries included), elimination Schedule and initial
state to 1e-12, the registry, the URDF shapes the locomotion models read
their contact radii from, and the body helpers' inertias.

Models: the eleven of bench_zoo.py besides the quadruped (which
tests/test_torch_model.py covers), slider, nslider and twister, which
come with the same code, and the eleven others of dojo_tpu's zoo (the
fixed-joint merge, loop joints: fourbar has no schedule).  Each reference
is built once per module; dojo_tpu's initial states are made with its jit
off (op by op: the same arithmetic, a few times faster than tracing and
compiling its minimal-coordinate maps per model)."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from dojo_tpu import builder as jbuilder
from dojo_tpu import models as jmodels
from dojo_tpu import urdf as jurdf
from dojo_tpu.graph import build_schedule as j_build_schedule
from dojo_tpu_torch import builder, models, urdf
from dojo_tpu_torch.core import Params
from dojo_tpu_torch.graph import build_schedule

MODELS = ("pendulum", "npendulum", "cartpole", "block", "sphere", "snake", "hopper",
          "halfcheetah", "walker", "ant", "humanoid", "slider", "nslider", "twister",
          "dzhanibekov", "tippetop", "raiberthopper", "block2d", "quadrotor", "uuv", "panda",
          "youbot", "exoskeleton", "atlas", "fourbar")
# bench_zoo's schedules: (W, N, S, levels, contacts)
SCHEDULES = {
    "pendulum": (6, 2, 4, 2, 0), "npendulum": (6, 10, 36, 10, 0), "cartpole": (6, 4, 12, 4, 0),
    "sphere": (14, 2, 4, 2, 1), "halfcheetah": (14, 14, 52, 8, 6), "ant": (14, 26, 100, 8, 9),
    "snake": (22, 4, 12, 4, 4), "hopper": (22, 8, 28, 8, 5), "walker": (22, 14, 52, 8, 9),
    "humanoid": (22, 26, 100, 12, 4), "block": (70, 2, 4, 2, 8),
    "dzhanibekov": (6, 4, 12, 4, 0), "tippetop": (14, 4, 12, 4, 2),
    "raiberthopper": (14, 4, 12, 4, 2), "block2d": (38, 2, 4, 2, 4),
    "quadrotor": (70, 2, 4, 2, 8), "uuv": (22, 2, 4, 2, 2), "panda": (14, 18, 68, 16, 0),
    "youbot": (14, 24, 92, 14, 0), "exoskeleton": (14, 8, 28, 8, 0),
    "atlas": (38, 62, 244, 22, 8),
}
NO_SCHEDULE = ("fourbar",)  # a kinematic loop: the dense path
URDFS = ("hopper", "halfcheetah", "walker", "ant", "humanoid", "atlas_simple",
         "pelican_fixed_rotors", "mini_tortuga_fixed_rotors", "panda_end_effector", "youbot",
         "model", "fourbar")
FLOATING = ("ant", "humanoid", "atlas_simple", "pelican_fixed_rotors")
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "dojo_tpu_torch", "assets")
PARAM_FIELDS = [f.name for f in dataclasses.fields(Params)]
_PAIRS = {}


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """(dojo_tpu mechanism, its initial state, the port's, the port's state)."""
    name = request.param
    if name not in _PAIRS:
        jm = jmodels.get_mechanism(name)
        tm = models.get_mechanism(name, device="cpu")
        with jax.disable_jit():
            js = jmodels.initialize(jm, name)
        _PAIRS[name] = (name, jm, js, tm, models.initialize(tm, name))
    return _PAIRS[name]


def test_params_match(pair):
    name, jm, _, tm, _ = pair
    for field in PARAM_FIELDS:
        ref = np.asarray(getattr(jm.params, field))
        got = getattr(tm.params, field)
        assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape, field
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12, err_msg=field)


def test_topology_matches(pair):
    name, jm, _, tm, _ = pair
    assert dataclasses.asdict(tm.topo) == dataclasses.asdict(jm.topo)
    assert tm.topo.contact_kind == jm.topo.contact_kind
    assert tm.topo.contact_geom == jm.topo.contact_geom
    assert set(tm.topo.contact_kind) <= {"nonlinear"}
    assert set(tm.topo.contact_geom) <= {"halfspace"}
    assert (tm.body_names, tm.joint_names, tm.contact_names) == (
        jm.body_names, jm.joint_names, jm.contact_names)


def test_schedule_matches(pair):
    name, jm, _, tm, _ = pair
    ref, got = j_build_schedule(jm.topo), build_schedule(tm.topo)
    if name in NO_SCHEDULE:
        assert ref is None and got is None and tm.topo.loop_joints == jm.topo.loop_joints != ()
        return
    assert (got.n_nodes, got.n_slots, got.width) == (ref.n_nodes, ref.n_slots, ref.width)
    if name in SCHEDULES:
        W, N, S, n_levels, nc = SCHEDULES[name]
        assert (got.width, got.n_nodes, got.n_slots, len(got.levels), tm.topo.nc) == (
            W, N, S, n_levels, nc)
    for f in ("node_width", "contact_offset", "joint_node", "joint_offset", "rows", "cols",
              "pad_eye", "real_diag", "vec_idx", "vec_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f), err_msg=f)
    assert got.slot == ref.slot and got.order == ref.order
    for a, b in zip(got.node_vars, ref.node_vars, strict=True):
        np.testing.assert_array_equal(a, b)
    assert len(got.levels) == len(ref.levels)
    for lg, lr in zip(got.levels, ref.levels):
        assert lg.real_w == lr.real_w
        for f in ("nodes", "upd_ai", "upd_inv", "upd_ib", "upd_tgt", "fwd_ai", "fwd_i",
                  "fwd_a", "bwd_ia", "bwd_i", "bwd_a"):
            np.testing.assert_array_equal(getattr(lg, f), getattr(lr, f), err_msg=f)


def test_initial_state_matches(pair):
    name, _, js, _, ts = pair
    for f in ("x", "q", "v", "w"):
        got = getattr(ts, f)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(js, f)), rtol=0, atol=1e-12,
                                   err_msg=f)


def test_registry_matches():
    """The port registers every name dojo_tpu registers (its 26), and each
    is in MODELS or the quadruped (tests/test_torch_model.py)."""
    ported = models.registered_models()
    assert ported == sorted(ported)
    assert ported == jmodels.registered_models() and len(ported) == 26
    assert set(MODELS) | {"quadruped"} == set(ported)


def _plain(shape):
    """A shape dict with numpy arrays as lists, for comparison."""
    if shape is None:
        return None
    out = {}
    for k, v in shape.items():
        if k == "shapes":
            v = [_plain(s) for s in v]
        elif isinstance(v, np.ndarray):
            v = np.round(v, 12).tolist()
        out[k] = v
    return out


@pytest.mark.parametrize("name", URDFS)
def test_urdf_shapes_match(name):
    """Body.shape of every parsed link, as dojo_tpu parses it (a mesh keeps
    its file name, whose base name dojo_tpu resolves against its own
    assets)."""
    path = os.path.join(ASSETS, f"{name}.urdf")
    got, _ = urdf.parse_urdf_defs(path, floating=name in FLOATING)
    ref, _ = jurdf.parse_urdf_defs(path, floating=name in FLOATING)
    assert [b.name for b in got] == [b.name for b in ref]
    shaped = with_radius = 0
    for g, r in zip(got, ref):
        gs, rs = _plain(g.shape), _plain(r.shape)
        for a, b in ((gs, rs), *zip((gs or {}).get("shapes", []), (rs or {}).get("shapes", []))):
            if b is not None and b["type"] == "mesh":  # dojo_tpu's path into its own assets
                assert os.path.basename(b["path"]) == os.path.basename(a["path"])
                b["path"] = a["path"]
        assert gs == rs, g.name
        shaped += gs is not None
        with_radius += gs is not None and "radius" in gs
    assert shaped > 0
    if name in URDFS[:5]:  # the locomotion models read their contact radii from these
        assert with_radius > 0


@pytest.mark.parametrize("helper, args", [
    ("box_body", (0.1, 0.2, 0.7, 1.3)),
    ("cylinder_body", (0.075, 1.0, 2.0)),
    ("sphere_body", (0.5, 1.5)),
])
def test_body_helpers_match(helper, args):
    got = getattr(builder, helper)("b", *args)
    ref = getattr(jbuilder, helper)("b", *args)
    np.testing.assert_allclose(got.inertia_matrix(), ref.inertia_matrix(), rtol=0, atol=1e-15)
    assert got.mass == ref.mass and got.shape == ref.shape
