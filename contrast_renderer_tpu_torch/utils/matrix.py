"""3D motors (dual quaternions), projection and 4x4 matrix helpers.

Replaces the reference's ppga3d motor / matrix utilities
(src/utils.rs:143-201) used by the example applications for camera and
instance transforms.

Conventions (matching the reference's observable layout):

- **motor3d**: shape (8,) = (q0, q1, q2, q3, s, t1, t2, t3).  The first
  four components are the rotation quaternion (w, x, y, z); the last four
  the dual part.  A pure translator by vector v is
  ``(1, 0, 0, 0, 0, -v0/2, -v1/2, -v2/2)`` (consistent with the
  reference's `motor2d_to_motor3d`, utils.rs:149-151).
- **mat4**: shape (4, 4) indexed ``[column][component]``, i.e. an array of
  four column vectors like the reference's ``[ppga3d::Point; 4]``
  (utils.rs:168-179).  ``apply_mat4(m, v)[c] == sum_j m[j][c] * v[j]``.
"""

from __future__ import annotations

import numpy as np


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _quat_conj(q):
    return np.array([q[0], -q[1], -q[2], -q[3]])


def rotate_around_axis(angle, axis):
    """Rotor for a rotation by `angle` radians around `axis`
    (reference utils.rs:143-146).  Returns a (4,) quaternion."""
    axis = np.asarray(axis, dtype=np.float64)
    s = np.sin(angle * 0.5)
    return np.array([np.cos(angle * 0.5), axis[0] * s, axis[1] * s, axis[2] * s])


def rotor_to_motor3d(q):
    q = np.asarray(q, dtype=np.float64)
    return np.concatenate([q, np.zeros(4)])


def translator3d(v):
    """Motor translating by 3-vector v."""
    v = np.asarray(v, dtype=np.float64)
    return np.array([1.0, 0.0, 0.0, 0.0, 0.0, -v[0] / 2, -v[1] / 2, -v[2] / 2])


def motor3d_new(components):
    """Raw component constructor, matching ppga3d::Motor::new's argument
    order (scalar, e23, e31, e12, e0123, e01, e02, e03)."""
    return np.asarray(components, dtype=np.float64)


def motor3d_product(a, b):
    """Geometric product of two motors: apply b first, then a."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    q = _quat_mul(a[:4], b[:4])
    d = _quat_mul(a[:4], b[4:]) + _quat_mul(a[4:], b[:4])
    return np.concatenate([q, d])


def motor2d_to_motor3d(motor):
    """Lift a 2D motor into a 3D motor (reference utils.rs:149-151)."""
    m = np.asarray(motor, dtype=np.float64)
    return np.array([m[0], 0.0, 0.0, m[1], 0.0, -m[3], m[2], 0.0])


def motor3d_rotation_matrix(q):
    """3x3 rotation matrix (columns = rotated basis vectors) of a unit
    quaternion."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)],
            [2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)],
            [2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)],
        ]
    ).T


def motor3d_translation(motor):
    """Translation vector encoded by a motor."""
    m = np.asarray(motor, dtype=np.float64)
    q, d = m[:4], m[4:]
    n = np.dot(q, q)
    t = _quat_mul(d, _quat_conj(q)) / n
    return -2.0 * t[1:]


def motor3d_to_mat4(motor):
    """Convert a 3D motor to a mat4 of columns (reference utils.rs:168-179).

    Columns 0..2 are the rotated x/y/z basis directions with w=0, column 3
    is the translation with w=1; component order within a column is
    (x, y, z, w).
    """
    m = np.asarray(motor, dtype=np.float64)
    rot = motor3d_rotation_matrix(m[:4])
    t = motor3d_translation(m)
    out = np.zeros((4, 4))
    for j in range(3):
        out[j, :3] = rot[:, j]
    out[3, :3] = t
    out[3, 3] = 1.0
    return out


def perspective_projection(field_of_view_y, aspect_ratio, near, far):
    """4x4 perspective projection (columns) (reference utils.rs:182-191)."""
    height = 1.0 / np.tan(field_of_view_y * 0.5)
    denominator = 1.0 / (near - far)
    return np.array(
        [
            [height / aspect_ratio, 0.0, 0.0, 0.0],
            [0.0, height, 0.0, 0.0],
            [0.0, 0.0, -far * denominator, 1.0],
            [0.0, 0.0, near * far * denominator, 0.0],
        ]
    )


def matrix_multiplication(a, b):
    """Product of two column-layout mat4s (reference utils.rs:194-201)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    # out[j] = sum_k a[k] * b[j][k]
    return np.einsum("kc,jk->jc", a, b)


def apply_mat4(m, v):
    """Apply a column-layout mat4 to a 4-vector."""
    m = np.asarray(m, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)
    return np.einsum("jc,...j->...c", m, v)


def identity_mat4():
    return np.eye(4)


def orthographic_projection(width, height):
    """Simple 2D-to-NDC orthographic mat4 mapping x∈[0,width], y∈[0,height]
    model space to NDC [-1,1]² (convenience for pixel-space scenes; no
    reference equivalent)."""
    return np.array(
        [
            [2.0 / width, 0.0, 0.0, 0.0],
            [0.0, 2.0 / height, 0.0, 0.0],
            [0.0, 0.0, 1.0, 0.0],
            [-1.0, -1.0, 0.0, 1.0],
        ]
    )
