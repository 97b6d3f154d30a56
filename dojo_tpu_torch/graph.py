"""Static block-elimination schedule over the mechanism graph.

The port's own numpy copy of dojo_tpu/graph.py (the rebuild of the
reference's GraphBasedSystems.jl elimination): node/edge blocks live in one
dense (batch, slots, W, W) array, and the factorization walks the schedule's
elimination levels leaves-to-root.  Contacts are folded into their parent
body as supernodes (load-bearing for float32: eliminating a foot contact
into a light body by a Schur complement cancels the small mass diagonal
catastrophically, while the pivoted in-block factorization of the
amalgamated node is backward stable); joints stay separate nodes,
eliminated after their child body.  Mechanisms with kinematic loops get no
schedule (None) and use the dense solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .core import Topology


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static elimination schedule (all numpy; identity-hashed)."""

    n_nodes: int
    n_slots: int  # diag slots (= n_nodes) + directed edge slots
    width: int  # common padded block width W
    node_width: np.ndarray  # (N,) real width per node
    node_vars: tuple  # per node: np.ndarray of w-indices (its variables)
    contact_offset: np.ndarray  # (nc,) offset of contact block inside its node
    joint_node: np.ndarray  # (nj,) node id holding each joint's variables
    joint_offset: np.ndarray  # (nj,) offset of joint block inside that node
    # gather maps for extracting blocks from the dense Jacobian
    rows: np.ndarray  # (S, W) row index into padded J (dim row = pad)
    cols: np.ndarray  # (S, W)
    pad_eye: np.ndarray  # (S, W, W) identity on pad dims of diag slots
    real_diag: np.ndarray  # (S, W, W) identity on real dims of diag slots
    slot: dict  # (a, b) directed node pair -> block slot
    levels: tuple  # tuple of LevelOps
    order: tuple  # node elimination order (for reference/debug)
    # w-vector gather/scatter for rhs
    vec_idx: np.ndarray  # (N, W) index into padded rhs vector
    vec_valid: np.ndarray  # (N, W) 1.0 where real

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclasses.dataclass(frozen=True)
class LevelOps:
    nodes: np.ndarray  # (k,) node ids eliminated at this level
    real_w: int  # max real block width among this level's nodes
    # Schur updates E[t] -= E[a,i] @ Dinv[i] @ E[i,b]
    upd_ai: np.ndarray  # (m,) slot of E_{a,i}
    upd_inv: np.ndarray  # (m,) node id i (index into Dinv storage)
    upd_ib: np.ndarray  # (m,) slot of E_{i,b}
    upd_tgt: np.ndarray  # (m,) slot of E_{a,b} (target, scatter-add)
    # forward solve: b_a -= E_{a,i} @ (Dinv_i b_i)
    fwd_ai: np.ndarray  # (f,) slot of E_{a,i}
    fwd_i: np.ndarray  # (f,) node i
    fwd_a: np.ndarray  # (f,) node a (target, scatter-add)
    # backward solve: x_i = Dinv_i (b_i - sum_a E_{i,a} x_a)
    bwd_ia: np.ndarray  # (g,) slot of E_{i,a}
    bwd_i: np.ndarray  # (g,) node i (target, scatter-add)
    bwd_a: np.ndarray  # (g,) node a


def build_schedule(topo: Topology):
    """Compute the static elimination schedule, or None → dense fallback.

    Returns None for graphs the leaves-first order can't handle exactly:
    kinematic loops (a joint whose parent AND child were both already
    reached — reference get_loop_joints, traversal.jl:33-77).
    """
    nb, nj, nc = topo.nb, topo.nj, topo.nc
    N = nb + nj
    if N == 0 or nb == 0:
        return None
    # each body must be the child of exactly one joint (tree); else fallback
    parent_joint = [None] * nb
    for j in range(nj):
        c = topo.joint_child[j]
        if parent_joint[c] is not None:
            return None  # kinematic loop (fourbar) → dense fallback
        parent_joint[c] = j
    if any(pj is None for pj in parent_joint):
        return None  # body without a parent joint → dense fallback
    jnode = lambda j: nb + j

    # ---- node variable index lists (contacts folded into parent bodies) ---
    node_vars = [[6 * b + k for k in range(6)] for b in range(nb)]
    contact_offset = np.zeros(nc, dtype=np.int32)
    for c in range(nc):
        p = topo.contact_parent[c]
        contact_offset[c] = len(node_vars[p])
        o = topo.contact_off + c * topo.cw
        node_vars[p].extend(range(o, o + topo.cw))
    joint_node = np.zeros(nj, dtype=np.int32)
    joint_offset = np.zeros(nj, dtype=np.int32)
    for j in range(nj):
        joint_node[j] = jnode(j)
        o = topo.joint_off + j * topo.jw
        node_vars.append(list(range(o, o + topo.jw)))
    node_vars = tuple(np.asarray(v, dtype=np.int32) for v in node_vars)
    widths = np.asarray([len(v) for v in node_vars])

    # ---- structural edges --------------------------------------------------
    edges = set()

    def add_edge(a, b):
        if a != b:
            edges.add((min(a, b), max(a, b)))

    for j in range(nj):
        p, c = topo.joint_parent[j], topo.joint_child[j]
        if p >= 0:
            add_edge(jnode(j), p)
            add_edge(p, c)  # damper body-body coupling (constraints.jl:208)
        add_edge(jnode(j), c)
    for c in range(nc):
        ch = topo.contact_child[c]
        if ch >= 0:  # body-body collision couples the two bodies
            add_edge(topo.contact_parent[c], ch)

    # ---- root-to-leaves DFS over system nodes (traversal.jl:11-31) --------
    # (joint eliminated after its child body so its λ-rows pick up the
    # G M⁻¹ Gᵀ Schur fill that makes its diagonal invertible)
    visited = [False] * nb
    preorder = []

    def visit_body(b):
        visited[b] = True
        preorder.append(jnode(parent_joint[b]))
        preorder.append(b)
        for j in range(nj):
            if topo.joint_parent[j] == b and not visited[topo.joint_child[j]]:
                visit_body(topo.joint_child[j])

    for j in range(nj):
        if topo.joint_parent[j] == -1 and not visited[topo.joint_child[j]]:
            visit_body(topo.joint_child[j])
    if not all(visited):
        return None  # disconnected bodies → dense fallback
    order = list(reversed(preorder))

    # ---- symbolic elimination: fill + levels + update lists ---------------
    pos = {n: k for k, n in enumerate(order)}
    neigh = {n: set() for n in range(N)}
    for a, b in edges:
        neigh[a].add(b)
        neigh[b].add(a)
    level = {}
    elim_updates = {}
    remaining_at = {}
    for i in order:
        rem = sorted(n for n in neigh[i] if pos[n] > pos[i])
        done = [n for n in neigh[i] if pos[n] < pos[i]]
        level[i] = 1 + max((level[d] for d in done), default=-1)
        remaining_at[i] = rem
        pairs = []
        for a in rem:
            for b in rem:
                pairs.append((a, b))
                if a < b:
                    add_edge(a, b)  # fill
                    neigh[a].add(b)
                    neigh[b].add(a)
        elim_updates[i] = pairs

    W = int(widths.max())
    dim = topo.dim

    # ---- slot table: diagonals then directed edges ------------------------
    slot = {}
    for n in range(N):
        slot[(n, n)] = n
    s = N
    for a, b in sorted(edges):
        slot[(a, b)] = s
        slot[(b, a)] = s + 1
        s += 2
    S = s

    rows = np.full((S, W), dim, dtype=np.int32)
    cols = np.full((S, W), dim, dtype=np.int32)
    pad_eye = np.zeros((S, W, W), dtype=np.float64)
    for (a, b), si in slot.items():
        wa, wb = widths[a], widths[b]
        rows[si, :wa] = node_vars[a]
        cols[si, :wb] = node_vars[b]
        if a == b:
            for k in range(wa, W):
                pad_eye[si, k, k] = 1.0

    # ---- level op lists ----------------------------------------------------
    max_level = max(level.values())
    levels = []
    for L in range(max_level + 1):
        nodes_L = [i for i in order if level[i] == L]
        upd_ai, upd_inv, upd_ib, upd_tgt = [], [], [], []
        fwd_ai, fwd_i, fwd_a = [], [], []
        bwd_ia, bwd_i, bwd_a = [], [], []
        for i in nodes_L:
            for a, b in elim_updates[i]:
                upd_ai.append(slot[(a, i)])
                upd_inv.append(i)
                upd_ib.append(slot[(i, b)])
                upd_tgt.append(slot[(a, b)])
            for a in remaining_at[i]:
                fwd_ai.append(slot[(a, i)])
                fwd_i.append(i)
                fwd_a.append(a)
                bwd_ia.append(slot[(i, a)])
                bwd_i.append(i)
                bwd_a.append(a)
        ar = lambda x: np.asarray(x, dtype=np.int32)
        levels.append(
            LevelOps(
                nodes=ar(nodes_L),
                real_w=int(max(widths[i] for i in nodes_L)),
                upd_ai=ar(upd_ai), upd_inv=ar(upd_inv),
                upd_ib=ar(upd_ib), upd_tgt=ar(upd_tgt),
                fwd_ai=ar(fwd_ai), fwd_i=ar(fwd_i), fwd_a=ar(fwd_a),
                bwd_ia=ar(bwd_ia), bwd_i=ar(bwd_i), bwd_a=ar(bwd_a),
            )
        )

    vec_idx = np.full((N, W), dim, dtype=np.int32)
    vec_valid = np.zeros((N, W), dtype=np.float64)
    for n in range(N):
        vec_idx[n, : widths[n]] = node_vars[n]
        vec_valid[n, : widths[n]] = 1.0

    real_diag = np.zeros((S, W, W), dtype=np.float64)
    for n in range(N):
        for k in range(widths[n]):
            real_diag[n, k, k] = 1.0

    return Schedule(
        n_nodes=N,
        n_slots=S,
        width=W,
        node_width=widths,
        node_vars=node_vars,
        contact_offset=contact_offset,
        joint_node=joint_node,
        joint_offset=joint_offset,
        rows=rows,
        cols=cols,
        pad_eye=pad_eye,
        real_diag=real_diag,
        slot=slot,
        levels=tuple(levels),
        order=tuple(order),
        vec_idx=vec_idx,
        vec_valid=vec_valid,
    )
