"""Quaternion / rotation math on tensors (counterpart of dojo_tpu/lie.py).

Quaternions are ``(..., 4)`` tensors in ``[w, x, y, z]`` order; every op
broadcasts over leading batch dimensions, so the same functions serve one
mechanism, a batch of lanes, and the per-joint/per-contact rows of the
residual.  Everything is written out-of-place with ``torch.where`` instead
of data-dependent branches, so ``torch.func.jvp``/``vmap`` trace through it
(the solver takes its Newton matrices by forward-mode AD, like the JAX
package takes ``jax.jacfwd``).
"""

from __future__ import annotations

import numpy as np
import torch

QUAT_ID = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)


def qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ∘ b for (..., 4) tensors."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def qconj(q: torch.Tensor) -> torch.Tensor:
    """Conjugate [w, -v]: the inverse of a unit quaternion."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


qinv = qconj


def qvec(v: torch.Tensor) -> torch.Tensor:
    """Embed a 3-vector as a pure quaternion [0, v]."""
    return torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)


def Lmat(q: torch.Tensor) -> torch.Tensor:
    """Left multiplication matrix: Lmat(q) @ p == qmul(q, p). (...,4,4)."""
    w, x, y, z = q.unbind(-1)
    r0 = torch.stack([w, -x, -y, -z], dim=-1)
    r1 = torch.stack([x, w, -z, y], dim=-1)
    r2 = torch.stack([y, z, w, -x], dim=-1)
    r3 = torch.stack([z, -y, x, w], dim=-1)
    return torch.stack([r0, r1, r2, r3], dim=-2)


def Rmat(q: torch.Tensor) -> torch.Tensor:
    """Right multiplication matrix: Rmat(q) @ p == qmul(p, q). (...,4,4)."""
    w, x, y, z = q.unbind(-1)
    r0 = torch.stack([w, -x, -y, -z], dim=-1)
    r1 = torch.stack([x, w, z, -y], dim=-1)
    r2 = torch.stack([y, -z, w, x], dim=-1)
    r3 = torch.stack([z, y, -x, w], dim=-1)
    return torch.stack([r0, r1, r2, r3], dim=-2)


def qmul_jac_right(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Jacobian of p ↦ a ∘ p ∘ s, i.e. Lmat(a) @ Rmat(s). (...,4,4)."""
    return Lmat(a) @ Rmat(s)


def rotate(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vector v by quaternion q: V(q ∘ [0,v] ∘ q⁻¹)."""
    return qmul(qmul(q, qvec(v)), qconj(q))[..., 1:]


def rotate_inv(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate v by q⁻¹ (world → body for body-to-world q)."""
    return qmul(qmul(qconj(q), qvec(v)), q)[..., 1:]


def rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix of unit quaternion q. (...,3,3)."""
    w, x, y, z = q.unbind(-1)
    r0 = torch.stack(
        [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        dim=-1,
    )
    r1 = torch.stack(
        [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
        dim=-1,
    )
    r2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
        dim=-1,
    )
    return torch.stack([r0, r1, r2], dim=-2)


def skew(p: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix: skew(p) @ v == cross(p, v). (...,3,3)."""
    x, y, z = p.unbind(-1)
    o = torch.zeros_like(x)
    r0 = torch.stack([o, -z, y], dim=-1)
    r1 = torch.stack([z, o, -x], dim=-1)
    r2 = torch.stack([-y, x, o], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def quat_perturb(q: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Tangent-space perturbation q ⊞ φ = q ∘ [1, φ]."""
    one = torch.ones_like(phi[..., :1])
    return qmul(q, torch.cat([one, phi], dim=-1))


# ---------------------------------------------------------------------------
# variational-integrator maps
# ---------------------------------------------------------------------------


def quaternion_map(w: torch.Tensor, timestep) -> torch.Tensor:
    """φ(ω) = [sqrt(4/h² − ‖ω‖²), ω]; the sqrt argument is clamped."""
    w2 = torch.sum(w * w, dim=-1, keepdim=True)
    arg = torch.maximum(
        4.0 / timestep**2 - w2, torch.as_tensor(1e-12 / timestep**2, dtype=w.dtype)
    )
    return torch.cat([torch.sqrt(arg), w], dim=-1)


def next_position(x2: torch.Tensor, v25: torch.Tensor, timestep) -> torch.Tensor:
    """x3 = x2 + v25 h."""
    return x2 + v25 * timestep


def next_orientation(q2: torch.Tensor, w25: torch.Tensor, timestep) -> torch.Tensor:
    """q3 = q2 ∘ φ(ω25) · h/2."""
    return qmul(q2, quaternion_map(w25, timestep)) * (timestep / 2.0)


def angular_velocity(q1: torch.Tensor, q2: torch.Tensor, timestep) -> torch.Tensor:
    """ω = 2/h · V(q1⁻¹ ∘ q2)."""
    return 2.0 / timestep * qmul(qconj(q1), q2)[..., 1:]


def cayley(w: torch.Tensor) -> torch.Tensor:
    """Cayley map ω → unit quaternion."""
    q = torch.cat([torch.ones_like(w[..., :1]), w], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# attitude parameterizations
# ---------------------------------------------------------------------------


def mrp(q: torch.Tensor) -> torch.Tensor:
    """Modified Rodrigues parameters v/(1+w)."""
    return q[..., 1:] / (q[..., :1] + 1.0)


def rotation_vector(q: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector θ·n of q, via MRP: 4·atan(‖m‖)·m/‖m‖ (Taylor-safe)."""
    m = mrp(q)
    r2 = torch.sum(m * m, dim=-1, keepdim=True)
    r = torch.sqrt(torch.clamp_min(r2, 1e-36))
    small = r2 < 1e-12
    rs = torch.where(small, torch.ones_like(r), r)
    exact = 4.0 * torch.atan(rs) / rs
    series = 4.0 * (1.0 - r2 / 3.0 + r2 * r2 / 5.0)
    return torch.where(small, series, exact) * m


def axis_angle_to_quaternion(x: torch.Tensor) -> torch.Tensor:
    """Rotation-vector → quaternion, Taylor-safe."""
    t2 = torch.sum(x * x, dim=-1, keepdim=True)
    t = torch.sqrt(torch.clamp_min(t2, 1e-36))
    small = t2 < 1e-12
    half = 0.5 * t
    exact = torch.sin(torch.where(small, torch.zeros_like(half), half)) / torch.where(
        small, torch.ones_like(t), t
    )
    series = 0.5 - t2 / 48.0
    sc = torch.where(small, series, exact)
    return torch.cat([torch.cos(half), sc * x], dim=-1)


def safe_normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Normalize with a zero guard (uniform fallback)."""
    n2 = torch.sum(x * x, dim=axis, keepdim=True)
    good = n2 > 0.0
    inv = torch.rsqrt(torch.where(good, n2, torch.ones_like(n2)))
    fallback = torch.ones_like(x) / x.shape[axis]
    return torch.where(good, x * inv, fallback)


def orthogonal_rows(axis):
    """Orthogonal complement rows of an axis (build-time, numpy).

    Returns (V1, V2, V3) with V3 == normalized axis, V1 ⟂ V2 ⟂ V3.
    """
    a = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(a)
    if n > 0:
        a = a / n
    sk = np.array(
        [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]], dtype=np.float64
    )
    _, _, vt = np.linalg.svd(sk)
    return vt[0], vt[1], a
