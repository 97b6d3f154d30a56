"""Core data model: static topology, parameter tensors, body state.

Counterpart of dojo_tpu/core.py.  ``Topology`` is the same hashable numpy
metadata (counts, index maps, pad widths); ``Params`` and ``BodyState`` are
dataclasses of tensors in place of the JAX NamedTuple pytrees.  A body
state may carry leading batch dimensions (one per lane); parameters are
shared by every lane.

Solver variable layout (one flat vector w, dimension ``Topology.dim``):

  [ body 0: v25(3) ω25(3) | body 1: ... |
    joint 0: tra[s_up(ML) s_lo(ML) γ_up(ML) γ_lo(ML) λ(3)] rot[...] | ... |
    contact 0: s(CW/2) γ(CW/2) | ... ]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Jacobian regularization, load-bearing (reference REG=1e-10).
REG = 1.0e-10

# contact block width per kind: [s; γ]
CONTACT_WIDTH = {"nonlinear": 8, "linear": 12, "impact": 2}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no CUDA device and no explicit request this raises — the port never
    carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dojo_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def tensor_map(fn, obj):
    """Apply fn to every tensor field of a dataclass; returns a new one."""
    return dataclasses.replace(
        obj,
        **{
            f.name: fn(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)
        },
    )


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static (hashable) mechanism metadata; fixes all shapes."""

    nb: int  # number of bodies (origin excluded)
    nj: int  # number of joints
    nc: int  # number of contacts
    maxlim: int  # joint-limit pad width per sub-joint (ML)
    cw: int  # contact block width (padded over contact kinds)

    joint_parent: tuple  # body index per joint, -1 = origin
    joint_child: tuple
    contact_parent: tuple  # body index per contact
    contact_child: tuple  # -1 = world (halfspace)
    contact_kind: tuple  # per contact: 'nonlinear' | 'linear' | 'impact'

    tra_nfree: tuple  # per joint: 3 - Nλ_tra (translational input dims)
    rot_nfree: tuple  # per joint: 3 - Nλ_rot

    root_to_leaves: tuple  # joint indices ordered root → leaves
    loop_joints: tuple = ()  # joints closing kinematic loops
    contact_geom: tuple = ()  # per contact collision pair geometry

    @property
    def sw(self) -> int:
        """Sub-joint block width: [s(2ML); γ(2ML); λ(3)]."""
        return 4 * self.maxlim + 3

    @property
    def jw(self) -> int:
        """Joint block width (translational + rotational sub-joints)."""
        return 2 * self.sw

    @property
    def body_off(self) -> int:
        return 0

    @property
    def joint_off(self) -> int:
        return 6 * self.nb

    @property
    def contact_off(self) -> int:
        return 6 * self.nb + self.nj * self.jw

    @property
    def dim(self) -> int:
        return 6 * self.nb + self.nj * self.jw + self.nc * self.cw

    @property
    def input_dim(self) -> int:
        return int(sum(self.tra_nfree) + sum(self.rot_nfree))

    @property
    def minimal_dim(self) -> int:
        return 2 * self.input_dim

    @property
    def maximal_dim(self) -> int:
        return 13 * self.nb

    def joint_slice(self, j):
        o = self.joint_off + j * self.jw
        return o, o + self.jw

    def contact_slice(self, c):
        o = self.contact_off + c * self.cw
        return o, o + self.cw


@dataclasses.dataclass
class Params:
    """Model parameters, one row per body/joint/contact (shared by lanes)."""

    # bodies
    mass: torch.Tensor  # (nb,)
    inertia: torch.Tensor  # (nb,3,3)

    # translational sub-joints
    tra_cmask: torch.Tensor  # (nj,3,3) constraint-mask rows, zero-padded
    tra_nmask: torch.Tensor  # (nj,3,3) nullspace-mask rows, zero-padded
    tra_lam_mask: torch.Tensor  # (nj,3) 1.0 where λ slot active
    tra_free_mask: torch.Tensor  # (nj,3) 1.0 where minimal coordinate exists
    tra_vertex_parent: torch.Tensor  # (nj,3)
    tra_vertex_child: torch.Tensor  # (nj,3)
    tra_spring: torch.Tensor  # (nj,)
    tra_damper: torch.Tensor  # (nj,)
    tra_spring_offset: torch.Tensor  # (nj,3)
    tra_lim_lo: torch.Tensor  # (nj,ML)
    tra_lim_hi: torch.Tensor  # (nj,ML)
    tra_lim_mask: torch.Tensor  # (nj,ML) 1.0 where limit active

    # rotational sub-joints
    rot_cmask: torch.Tensor
    rot_nmask: torch.Tensor
    rot_lam_mask: torch.Tensor
    rot_free_mask: torch.Tensor
    rot_offset: torch.Tensor  # (nj,4) orientation_offset quaternion
    rot_spring: torch.Tensor
    rot_damper: torch.Tensor
    rot_spring_offset: torch.Tensor
    rot_lim_lo: torch.Tensor
    rot_lim_hi: torch.Tensor
    rot_lim_mask: torch.Tensor

    # contacts
    contact_friction: torch.Tensor  # (nc,)
    contact_normal: torch.Tensor  # (nc,3)
    contact_tangent: torch.Tensor  # (nc,2,3)
    contact_origin: torch.Tensor  # (nc,3)
    contact_radius: torch.Tensor  # (nc,)
    contact_offset: torch.Tensor  # (nc,3)
    contact_child_origin: torch.Tensor  # (nc,3)
    contact_child_radius: torch.Tensor  # (nc,)
    contact_aux: torch.Tensor  # (nc,6)

    # world
    gravity: torch.Tensor  # (3,)
    timestep: torch.Tensor  # ()


@dataclasses.dataclass
class BodyState:
    """Maximal-coordinate state, one row per body, any leading batch dims.

    x: position x2 (...,nb,3);  q: orientation q2 (...,nb,4);
    v: midpoint linear velocity v15;  w: midpoint angular velocity ω15.
    """

    x: torch.Tensor
    q: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor

    def pack(self) -> torch.Tensor:
        """Flatten to the 13·Nb maximal vector [x v q ω]·Nb."""
        z = torch.cat([self.x, self.v, self.q, self.w], dim=-1)
        return z.reshape(*self.x.shape[:-2], -1)

    @classmethod
    def unpack(cls, z: torch.Tensor, nb: int) -> "BodyState":
        z = z.reshape(*z.shape[:-1], nb, 13)
        return cls(x=z[..., 0:3], v=z[..., 3:6], q=z[..., 6:10], w=z[..., 10:13])


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Interior-point solver options; defaults identical to dojo_tpu's.

    See dojo_tpu/core.py SolverOptions for the measurements behind each
    default (undercut=10, refine=1, rescue, warm-onset re-centering)."""

    rtol: float = 1.0e-6
    btol: float = 1.0e-4
    max_iter: int = 50
    max_ls: int = 10
    # μ floor is btol/undercut; keeps cone pairs strictly interior in f32
    undercut: float = 10.0
    # run the block LDU in float64 for float32 simulations (escape hatch)
    ldu_f64: bool = False
    # iterative-refinement sweeps per linear solve on the float32 LDU path
    refine: int = 1
    no_progress_max: int = 3
    no_progress_undercut: float = 10.0
    # interior floor applied to carried-over cone pairs of a warm start
    warm_floor: float = 1e-2
    # dense pivoted-LU rescue of lanes where the float32 block LDU stalls
    rescue: bool = True
    # impact-onset warm-start re-centering (margin < 0 disables)
    warm_onset_margin: float = 0.05
    warm_onset_gamma: float = 0.1


def cone_index_sets(topo: Topology):
    """Static index arrays describing all cone slots of the w vector.

    Returns dict of numpy arrays:
      ort_s, ort_g      — positive-orthant pair indices into w
      joint_slot        — (n_ort_joint, 3): owning (joint, sub, limit-slot)
      soc_s, soc_g      — (n_soc, 3) second-order-cone triplets
    """
    ML, SW = topo.maxlim, topo.sw
    ort_s, ort_g, joint_slot = [], [], []
    for j in range(topo.nj):
        base = topo.joint_off + j * topo.jw
        for sub in range(2):  # 0 = tra, 1 = rot
            o = base + sub * SW
            for i in range(2 * ML):  # [s_up; s_lo] slots
                ort_s.append(o + i)
                ort_g.append(o + 2 * ML + i)
                joint_slot.append((j, sub, i % ML if ML else 0))
    n_joint_ort = len(ort_s)
    soc_s, soc_g = [], []
    for c in range(topo.nc):
        o = topo.contact_off + c * topo.cw
        kind = topo.contact_kind[c]
        nhalf = CONTACT_WIDTH[kind] // 2
        half = topo.cw // 2  # padded half-width: γ block starts at o + half
        if kind == "nonlinear":
            # slot 0: impact pair (ort); slots 1-3: friction SOC pair
            ort_s.append(o + 0)
            ort_g.append(o + half)
            soc_s.append([o + 1, o + 2, o + 3])
            soc_g.append([o + half + 1, o + half + 2, o + half + 3])
        else:
            for i in range(nhalf):
                ort_s.append(o + i)
                ort_g.append(o + half + i)
    return {
        "ort_s": np.asarray(ort_s, dtype=np.int64).reshape(-1),
        "ort_g": np.asarray(ort_g, dtype=np.int64).reshape(-1),
        "n_joint_ort": n_joint_ort,
        "joint_slot": np.asarray(joint_slot, dtype=np.int64).reshape(-1, 3),
        "soc_s": np.asarray(soc_s, dtype=np.int64).reshape(-1, 3),
        "soc_g": np.asarray(soc_g, dtype=np.int64).reshape(-1, 3),
    }


def joint_limit_activity(topo: Topology, params: Params) -> torch.Tensor:
    """Activity (0/1) of each joint-limit ort pair, ordered as in
    cone_index_sets (joint-major, [tra, rot], [s_up(ML); s_lo(ML)])."""
    if topo.nj == 0 or topo.maxlim == 0:
        return params.mass.new_zeros((0,))
    tra = torch.cat([params.tra_lim_mask, params.tra_lim_mask], dim=1)
    rot = torch.cat([params.rot_lim_mask, params.rot_lim_mask], dim=1)
    return torch.cat([tra, rot], dim=1).reshape(-1)
