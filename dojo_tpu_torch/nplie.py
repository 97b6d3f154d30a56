"""Numpy quaternion helpers for build-time code (URDF parsing, mechanism
assembly, forward kinematics of the zero configuration).

The port's own copy of dojo_tpu/nplie.py: the same semantics as the tensor
versions in lie.py, run on the host so that building a mechanism launches
nothing on the device.
"""

from __future__ import annotations

import numpy as np


def qmul(a, b):
    """Hamilton product a*b for [w,x,y,z] quaternions."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dtype=np.float64,
    )


def qconj(q):
    return np.asarray(q, dtype=np.float64) * np.array([1.0, -1.0, -1.0, -1.0])


def rotation_matrix(q):
    """3x3 rotation matrix of unit quaternion q."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    return np.array(
        [
            [w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z],
        ]
    )


def rotate(v, q):
    """Rotate vector v by quaternion q."""
    return rotation_matrix(q) @ np.asarray(v, dtype=np.float64)


def rpy_to_quat(rpy):
    """URDF roll-pitch-yaw (fixed-axis XYZ) to quaternion."""
    r, p, y = np.asarray(rpy, dtype=np.float64)

    def rot(angle, axis):
        q = np.zeros(4)
        q[0] = np.cos(angle / 2)
        q[axis + 1] = np.sin(angle / 2)
        return q

    return qmul(qmul(rot(y, 2), rot(p, 1)), rot(r, 0))
