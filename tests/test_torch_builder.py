"""The port's host-side builders against dojo_tpu's, on the same inputs:
the merge of bodies across fixed joints (builder.reduce_fixed_joints, on
tests/test_reduce.py's two mechanisms and on the URDF models that merge
welded bodies, contacts included), the re-rooting of a chain
(builder.set_floating_base, on tests/test_floating_base.py's chain), the
loop joints of a URDF (fourbar), and the body helpers' inertias.  The
definitions each returns are compared field by field (1e-12), then built
into Params and Topology in both packages.  Nothing here compiles a JAX
function."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import dojo_tpu as dt
from dojo_tpu import builder as jbuilder
from dojo_tpu import urdf as jurdf
from dojo_tpu_torch import builder, nplie, urdf
from dojo_tpu_torch.core import Params

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "dojo_tpu_torch", "assets")


def _quat(rv):
    """The unit quaternion of a rotation vector (numpy)."""
    rv = np.asarray(rv, dtype=np.float64)
    th = np.linalg.norm(rv)
    return np.concatenate([[np.cos(th / 2)], np.sin(th / 2) * rv / th])


def _defs(pkg, mechanism):
    """tests/test_reduce.py's and tests/test_floating_base.py's mechanisms
    as definition lists of one package (`pkg`: dojo_tpu or the port's
    builder)."""
    if mechanism == "welded_chain":
        q = _quat([0.0, 0.3, 0.4])
        bodies = [pkg.box_body("a", 0.1, 0.1, 0.4, 1.0), pkg.box_body("b", 0.1, 0.1, 0.3, 0.7),
                  pkg.box_body("c", 0.1, 0.1, 0.5, 0.4)]
        joints = [
            pkg.JointDef(kind="revolute", parent="origin", child="a", axis=[0, 1, 0],
                         child_vertex=[0, 0, 0.2]),
            pkg.JointDef(kind="fixed", parent="a", child="b", parent_vertex=[0, 0, -0.2],
                         child_vertex=[0.02, 0, 0.15], orientation_offset=q),
            pkg.JointDef(kind="revolute", parent="b", child="c", axis=[1, 0, 0],
                         parent_vertex=[0.01, 0, -0.15], child_vertex=[0, 0, 0.25]),
        ]
        contacts = [pkg.ContactDef(body="b", origin=[0.03, 0.0, -0.15], radius=0.02),
                    pkg.ContactDef(body="a", origin=[0.0, 0.01, 0.2])]
        return bodies, joints, contacts
    if mechanism == "welded_loop":  # the coupler welded to a crank, closing a loop
        q = _quat([0.2, 0.0, 0.5])
        in_c = lambda v: nplie.rotation_matrix(q).T @ np.asarray(v, np.float64)
        bodies = [pkg.box_body("a", 0.02, 0.02, 0.4, 1.0), pkg.box_body("b", 0.02, 0.02, 0.4, 0.8),
                  pkg.box_body("c", 0.04, 0.04, 0.04, 0.3)]
        joints = [
            pkg.JointDef(kind="revolute", parent="origin", child="a", axis=[0, 1, 0],
                         child_vertex=[0, 0, 0.2]),
            pkg.JointDef(kind="revolute", parent="origin", child="b", axis=[0, 1, 0],
                         parent_vertex=[0.1, 0, 0], child_vertex=[0, 0, 0.2]),
            pkg.JointDef(kind="fixed", parent="b", child="c", parent_vertex=[0, 0, -0.2],
                         child_vertex=in_c([0.05, 0, 0]), orientation_offset=q),
            pkg.JointDef(kind="revolute", parent="a", child="c", axis=[0, 1, 0],
                         parent_vertex=[0, 0, -0.2], child_vertex=in_c([-0.05, 0, 0]),
                         orientation_offset=q),
        ]
        return bodies, joints, [pkg.ContactDef(body="c", origin=[0.0, 0.0, -0.02])]
    q = _quat([0.1, 0.25, -0.2])  # the floating chain
    bodies = [pkg.box_body("a", 0.1, 0.1, 0.4, 1.0), pkg.box_body("b", 0.1, 0.1, 0.3, 0.7),
              pkg.box_body("c", 0.1, 0.1, 0.5, 0.4)]
    joints = [
        pkg.JointDef(kind="floating", parent="origin", child="a", name="base"),
        pkg.JointDef(kind="revolute", parent="a", child="b", axis=[0, 1, 0],
                     parent_vertex=[0, 0, -0.2], child_vertex=[0, 0, 0.15], spring=2.0,
                     damper=0.1, name="ab"),
        pkg.JointDef(kind="revolute", parent="b", child="c", axis=[1, 0, 0],
                     parent_vertex=[0.01, 0, -0.15], child_vertex=[0, 0, 0.25],
                     orientation_offset=q, name="bc"),
    ]
    return bodies, joints, []


def _same(got, ref, what):
    """Two lists of Body / JointDef / ContactDef definitions, field by field
    (numbers to 1e-12; an axis override None in both; a body's shape is
    tests/test_torch_zoo.py's)."""
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(r, f.name)
            if f.name == "shape":
                continue
            if a is None or b is None or isinstance(a, str):
                assert a == b, (what, f.name, a, b)
            else:
                np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                           rtol=0, atol=1e-12, err_msg=f"{what} {f.name}")


def _same_build(got, ref):
    """builder.build and dojo_tpu's build of the two lists: Params and
    Topology."""
    tm, jm = builder.build(*got, device="cpu"), jbuilder.build(*ref)
    assert dataclasses.asdict(tm.topo) == dataclasses.asdict(jm.topo)
    for f in dataclasses.fields(Params):
        np.testing.assert_allclose(getattr(tm.params, f.name).numpy(),
                                   np.asarray(getattr(jm.params, f.name)), rtol=0, atol=1e-12,
                                   err_msg=f.name)


@pytest.mark.parametrize("mechanism", ["welded_chain", "welded_loop"])
def test_reduce_fixed_joints_matches_dojo_tpu(mechanism):
    """tests/test_reduce.py's mechanisms (a fixed joint with a rotation
    offset in a chain, and one that welds a loop's coupler, so that the
    loop joint's child is the merged body), with contacts on the merged
    bodies: the merged bodies, rewritten joints and contacts, and the built
    mechanism."""
    got = builder.reduce_fixed_joints(*_defs(builder, mechanism))
    ref = jbuilder.reduce_fixed_joints(*_defs(jbuilder, mechanism))
    for g, r, what in zip(got, ref, ("bodies", "joints", "contacts")):
        _same(g, r, f"{mechanism} {what}")
    assert all(j.kind != "fixed" for j in got[1])
    _same_build(got, ref)


@pytest.mark.parametrize("name, floating", [("atlas_simple", True),
                                            ("pelican_fixed_rotors", True),
                                            ("mini_tortuga_fixed_rotors", False),
                                            ("panda_end_effector", False)])
def test_reduce_fixed_joints_urdf_matches_dojo_tpu(name, floating):
    """The welded bodies of the URDF models (the rotors and thrusters, the
    panda's flange; atlas_simple welds none), with a contact on every
    body."""
    path = os.path.join(ASSETS, f"{name}.urdf")
    tb, tj = urdf.parse_urdf_defs(path, floating=floating)
    jb, jj = jurdf.parse_urdf_defs(path, floating=floating)
    tc = [builder.ContactDef(body=b.name, origin=[0.01, -0.02, 0.03], radius=0.05) for b in tb]
    jc = [jbuilder.ContactDef(body=b.name, origin=[0.01, -0.02, 0.03], radius=0.05) for b in jb]
    got, ref = builder.reduce_fixed_joints(tb, tj, tc), jbuilder.reduce_fixed_joints(jb, jj, jc)
    assert (len(got[0]) < len(tb)) == (name != "atlas_simple")
    for g, r, what in zip(got, ref, ("bodies", "joints", "contacts")):
        _same(g, r, f"{name} {what}")
    _same_build(got, ref)


@pytest.mark.parametrize("root", ["b", "c"])
def test_set_floating_base_matches_dojo_tpu(root):
    """tests/test_floating_base.py's floating chain re-rooted at b and at c:
    the reversed joints (parent and child, vertices, axes, offsets) and the
    built mechanism; a loop raises in both."""
    got = builder.set_floating_base(*_defs(builder, "chain")[:2], root)
    ref = jbuilder.set_floating_base(*_defs(jbuilder, "chain")[:2], root)
    _same(got[0], ref[0], "bodies")
    _same(got[1], ref[1], "joints")
    assert next(j for j in got[1] if j.parent == "origin").child == root
    _same_build((*got, []), (*ref, []))
    with pytest.raises(ValueError, match="loop"):
        builder.set_floating_base(*_defs(builder, "welded_loop")[:2], "a")


def test_loop_joints_parse_like_dojo_tpu():
    """fourbar.urdf's <loop_joint>: appended after the tree's joints with
    its vertices in the two links' body frames, as dojo_tpu parses it; the
    built topology lists it as a loop joint."""
    path = os.path.join(ASSETS, "fourbar.urdf")
    tb, tj = urdf.parse_urdf_defs(path)
    jb, jj = jurdf.parse_urdf_defs(path)
    _same(tb, jb, "bodies")
    _same(tj, jj, "joints")
    _same_build((tb, tj, []), (jb, jj, []))
    topo = builder.build(tb, tj, [], device="cpu").topo
    assert len(topo.loop_joints) == 1 and topo.nj == len(tb) + 1


@pytest.mark.parametrize("helper, args", [
    ("capsule_body", (0.05, 0.3, 1.7)),
    ("pyramid_body", (0.4, 0.6, 2.0)),
    ("mesh_body", (1.5, np.diag([0.1, 0.2, 0.3]), "mesh/head.obj", (2.0, 2.0, 2.0))),
    ("combined_body", (1.5, np.diag([0.1, 0.2, 0.3]), [{"type": "sphere", "r": 0.1}])),
])
def test_more_body_helpers_match(helper, args):
    got = getattr(builder, helper)("b", *args)
    ref = getattr(jbuilder, helper)("b", *args)
    np.testing.assert_allclose(got.inertia_matrix(), ref.inertia_matrix(), rtol=0, atol=1e-15)
    assert got.mass == ref.mass and got.shape == ref.shape
    assert getattr(__import__("dojo_tpu_torch"), helper) is getattr(builder, helper)
    assert getattr(dt, helper) is getattr(jbuilder, helper)
