"""URDF → joint/body definitions (counterpart of dojo_tpu/urdf.py).

Parses links and joints with xml.etree, then runs the placement pass: each
body's frame is its inertial (COM) frame; joint anchors and orientation
offsets come from the chained URDF joint origins, root → leaves.  With
``floating=True`` a floating-base joint is prepended.  Visual geometry is
not parsed: the simulation never reads it.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from . import builder as bd
from . import nplie

URDF_JOINT_KINDS = {
    "revolute": "revolute",
    "continuous": "revolute",
    "prismatic": "prismatic",
    "planar": "planar",
    "planarfree": "planar_free",
    "planaraxis": "planar_axis",
    "fixed": "fixed",
    "floating": "floating",
    "orbital": "orbital",
    "ball": "spherical",
    "spherical": "spherical",
    "fixedorientation": "fixed_orientation",
    "cylindrical": "cylindrical",
    "cylindricalfree": "cylindrical_free",
}


def _pose(el):
    if el is None:
        return np.zeros(3), np.array([1.0, 0, 0, 0])
    xyz = np.fromstring(el.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(el.get("rpy", "0 0 0"), sep=" ")
    return xyz, nplie.rpy_to_quat(rpy)


def _inertial(link):
    el = link.find("inertial")
    if el is None:
        return np.zeros(3), np.array([1.0, 0, 0, 0]), 0.0, np.zeros((3, 3))
    x, q = _pose(el.find("origin"))
    m = float(el.find("mass").get("value", "0")) if el.find("mass") is not None else 0.0
    J = np.zeros((3, 3))
    ine = el.find("inertia")
    if ine is not None:
        g = lambda k: float(ine.get(k, "0"))
        J = np.array(
            [
                [g("ixx"), g("ixy"), g("ixz")],
                [g("ixy"), g("iyy"), g("iyz")],
                [g("ixz"), g("iyz"), g("izz")],
            ]
        )
    return x, q, m, J


def _qconj(q):
    return q * np.array([1.0, -1, -1, -1])


def parse_urdf_defs(path, floating=False, parse_dampers=True):
    """Parse a URDF into (bodies, jointdefs) for customization before
    builder.build."""
    root = ET.parse(path).getroot()
    if root.tag != "robot":
        raise ValueError(f"{path}: root element is <{root.tag}>, not <robot>")

    links = {l.get("name"): l for l in root.findall("link")}
    xjoints = root.findall("joint")
    if root.findall("loop_joint"):
        raise NotImplementedError("loop joints are not ported yet")

    inert = {name: _inertial(el) for name, el in links.items()}
    child_names = {j.find("child").get("link") for j in xjoints}
    roots = [n for n in links if n not in child_names]
    if len(roots) != 1:
        raise ValueError(f"{path}: expected one root link, found {roots}")
    root_link = roots[0]
    body_names = [n for n in links if n != root_link or floating]

    recs = []
    for j in xjoints:
        parent = j.find("parent").get("link")
        x, q = _pose(j.find("origin"))
        ax = j.find("axis")
        dyn = j.find("dynamics")
        rec = dict(
            kind=URDF_JOINT_KINDS[j.get("type")],
            parent=parent,
            child=j.find("child").get("link"),
            x=x,
            q=q,
            axis=np.fromstring(ax.get("xyz"), sep=" ") if ax is not None else np.array([1.0, 0, 0]),
            damper=float(dyn.get("damping", "0")) if (dyn is not None and parse_dampers) else 0.0,
            name=j.get("name"),
        )
        if parent == root_link and not floating:
            recs.insert(0, rec)
        else:
            recs.append(rec)
    if floating:
        recs.insert(
            0,
            dict(
                kind="floating", parent=root_link, child=root_link, x=np.zeros(3),
                q=np.array([1.0, 0, 0, 0]), axis=np.array([1.0, 0, 0]),
                damper=0.0, name="floating_base", _base=True,
            ),
        )

    # ---- placement pass: world poses of joints and bodies ----------------
    jxw, jqw = {}, {}
    bxw = {root_link: np.zeros(3)}
    bqw = {root_link: np.array([1.0, 0, 0, 0])}
    parent_joint = {}
    jointdefs = []
    out_parent = lambda n: "origin" if (n == root_link and not floating) else n

    placed = {root_link}
    pending = list(recs)
    while pending:
        progressed = False
        for i, r in enumerate(pending):
            if r["parent"] not in placed:
                continue
            pending.pop(i)
            progressed = True
            if r.get("_base"):
                xi, qi, _, _ = inert[root_link]
                bxw[root_link], bqw[root_link] = xi, qi
                jxw[r["name"]] = np.zeros(3)
                jqw[r["name"]] = np.array([1.0, 0, 0, 0])
                parent_joint[root_link] = r
                jointdefs.append(
                    bd.JointDef(
                        kind="floating", parent="origin", child=root_link,
                        damper=r["damper"], name=r["name"],
                    )
                )
                placed.add("__base__")
                break
            pname, cname = r["parent"], r["child"]
            if pname == root_link and not floating and pname not in parent_joint:
                xpj, qpj = np.zeros(3), np.array([1.0, 0, 0, 0])
            else:
                pj = parent_joint[pname]
                xpj, qpj = jxw[pj["name"]], jqw[pj["name"]]
            xpb, qpb = bxw[pname], bqw[pname]
            # joint pose in the parent-body frame
            xjl = nplie.rotate(xpj + nplie.rotate(r["x"], qpj) - xpb, _qconj(qpb))
            qjl = nplie.qmul(_qconj(qpb), nplie.qmul(qpj, r["q"]))
            jxw[r["name"]] = xpb + nplie.rotate(xjl, qpb)
            jqw[r["name"]] = nplie.qmul(qpb, qjl)
            # child body frame = child link inertial frame
            xbl, qbl, _, _ = inert[cname]
            offset = nplie.qmul(qjl, qbl)
            parent_vertex = xjl
            child_vertex = nplie.rotate(-xbl, _qconj(qbl))
            qb = nplie.qmul(qpb, offset)
            bxw[cname] = xpb + nplie.rotate(parent_vertex, qpb) - nplie.rotate(child_vertex, qb)
            bqw[cname] = qb
            parent_joint[cname] = r
            jointdefs.append(
                bd.JointDef(
                    kind=r["kind"],
                    parent=out_parent(pname),
                    child=cname,
                    axis=r["axis"],
                    parent_vertex=parent_vertex,
                    child_vertex=child_vertex,
                    orientation_offset=offset,
                    damper=r["damper"],
                    name=r["name"],
                )
            )
            placed.add(cname)
            break
        if not progressed:
            raise ValueError(f"unplaceable joints: {[r['name'] for r in pending]}")

    bodies = []
    for n in body_names:
        _, _, m, J = inert[n]
        bodies.append(bd.Body(n, m, J))
    return bodies, jointdefs


def apply_zoo_options(jointdefs, springs=None, dampers=None, joint_limits=None,
                      rot_spring_offsets=None):
    """Post-parse springs/dampers/limits/spring offsets (the zoo's idiom);
    the floating base gets neither springs nor dampers."""
    for jd in jointdefs:
        if springs is not None and jd.kind != "floating":
            jd.spring = float(springs)
        if dampers is not None and jd.kind != "floating":
            jd.damper = float(dampers)
        if joint_limits and jd.name in joint_limits:
            lo, hi = joint_limits[jd.name]
            lim = (np.atleast_1d(lo), np.atleast_1d(hi))
            # limits attach to the sub-joint with free coordinates
            if jd.kind in ("prismatic", "planar", "fixed_orientation",
                           "planar_free", "cylindrical_free"):
                jd.tra_limits = lim
            else:
                jd.rot_limits = lim
        if rot_spring_offsets and jd.name in rot_spring_offsets:
            jd.rot_spring_offset = np.atleast_1d(rot_spring_offsets[jd.name])
    return jointdefs
