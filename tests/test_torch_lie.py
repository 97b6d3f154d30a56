"""dojo_tpu_torch.lie against dojo_tpu.lie on random inputs (float64, 1e-12).

The inputs are made with numpy from a seed and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dojo_tpu import lie as jl
from dojo_tpu_torch import lie as tl

H = 0.05


def _inputs(seed=0, n=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = [1.0, 1e-8, -2e-8, 0.0]  # near identity: Taylor branches
    q[0] /= np.linalg.norm(q[0])
    p = rng.standard_normal((n, 4))
    v = rng.standard_normal((n, 3))
    v[1] = 0.0  # zero vector: safe_normalize fallback, small-angle branch
    w = rng.standard_normal((n, 3))
    return dict(q=q, p=p, v=v, w=w, small=1e-7 * w)


CASES = {
    "qmul": lambda m, d: m.qmul(d["q"], d["p"]),
    "qconj": lambda m, d: m.qconj(d["q"]),
    "qinv": lambda m, d: m.qinv(d["p"]),
    "qvec": lambda m, d: m.qvec(d["v"]),
    "Lmat": lambda m, d: m.Lmat(d["q"]),
    "Rmat": lambda m, d: m.Rmat(d["q"]),
    "qmul_jac_right": lambda m, d: m.qmul_jac_right(d["q"], d["p"]),
    "rotate": lambda m, d: m.rotate(d["v"], d["q"]),
    "rotate_inv": lambda m, d: m.rotate_inv(d["v"], d["q"]),
    "rotation_matrix": lambda m, d: m.rotation_matrix(d["q"]),
    "skew": lambda m, d: m.skew(d["v"]),
    "quat_perturb": lambda m, d: m.quat_perturb(d["q"], d["w"]),
    "quaternion_map": lambda m, d: m.quaternion_map(d["w"], H),
    "quaternion_map_clamped": lambda m, d: m.quaternion_map(100.0 * d["w"], H),
    "next_position": lambda m, d: m.next_position(d["v"], d["w"], H),
    "next_orientation": lambda m, d: m.next_orientation(d["q"], d["w"], H),
    "angular_velocity": lambda m, d: m.angular_velocity(d["q"], d["p"], H),
    "cayley": lambda m, d: m.cayley(d["w"]),
    "mrp": lambda m, d: m.mrp(d["q"]),
    "rotation_vector": lambda m, d: m.rotation_vector(d["q"]),
    "axis_angle_to_quaternion": lambda m, d: m.axis_angle_to_quaternion(d["v"]),
    "axis_angle_small": lambda m, d: m.axis_angle_to_quaternion(d["small"]),
    "safe_normalize": lambda m, d: m.safe_normalize(d["v"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_lie_matches_reference(name, seed):
    d = _inputs(seed)
    ref = CASES[name](jl, {k: jnp.asarray(a) for k, a in d.items()})
    got = CASES[name](tl, {k: torch.as_tensor(a) for k, a in d.items()})
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_orthogonal_rows_matches_reference():
    rng = np.random.default_rng(3)
    for axis in [(0, 0, 1), (1, 0, 0), *rng.standard_normal((4, 3))]:
        for a, b in zip(tl.orthogonal_rows(axis), jl.orthogonal_rows(axis)):
            np.testing.assert_allclose(a, b, atol=1e-12)


def test_quat_id():
    np.testing.assert_array_equal(tl.QUAT_ID.numpy(), np.asarray(jl.QUAT_ID))


def test_lie_broadcasts_over_leading_dims():
    """The port's functions take any leading batch dims (dojo_tpu vmaps)."""
    d = _inputs(5)
    q = torch.as_tensor(d["q"]).reshape(4, 4, 4)
    v = torch.as_tensor(d["v"]).reshape(4, 4, 3)
    flat = tl.rotate(v.reshape(-1, 3), q.reshape(-1, 4)).reshape(4, 4, 3)
    torch.testing.assert_close(tl.rotate(v, q), flat, rtol=0, atol=0)
