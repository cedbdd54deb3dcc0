"""Quaternion and rotation utilities (batched torch).

Conventions match ``privacy_preserving_sfm_tpu/ops/lie.py`` and the
reference (``src/base/pose.cc:34-127``):
  * quaternions are ``(w, x, y, z)`` scalar-first,
  * a pose ``(qvec, tvec)`` maps world points into the camera frame:
    ``x_cam = R(qvec) @ x_world + tvec``.

All functions broadcast over arbitrary leading batch dimensions and are
``torch.func`` transformable (no in-place ops, no data-dependent control
flow).
"""

from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) to unit norm. q: (..., 4)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q. (...,4),(...,3)->(...,3)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, both (w,x,y,z)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (w, -x, -y, -z): the inverse of a unit quaternion."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation matrix. (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz,
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w,x,y,z), branch-free: the four
    Shepperd candidates, the one with the largest pivot (first on ties),
    sign fixed to w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = qw.clamp_min(1e-12)
    s = torch.sqrt(qw)
    s0, s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    cand = torch.stack(
        [
            torch.stack([s0, (m21 - m12) / s0, (m02 - m20) / s0,
                         (m10 - m01) / s0], dim=-1),
            torch.stack([(m21 - m12) / s1, s1, (m01 + m10) / s1,
                         (m02 + m20) / s1], dim=-1),
            torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2,
                         (m12 + m21) / s2], dim=-1),
            torch.stack([(m10 - m01) / s3, (m02 + m20) / s3,
                         (m12 + m21) / s3, s3], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    best = torch.argmax(qw, dim=-1)
    q = torch.take_along_dim(cand, best[..., None, None].expand(
        best.shape + (1, 4)), dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Shortest-arc unit quaternion rotating direction a onto direction b
    (``Eigen::Quaterniond::FromTwoVectors``, reference
    ``src/init/initializer.cc:73``); antiparallel inputs turn by pi about
    an axis orthogonal to ``a``."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    c = _cross(a, b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    q = torch.cat([1.0 + d, c], dim=-1)
    ex = a.new_tensor([1.0, 0.0, 0.0]).expand(a.shape)
    ey = a.new_tensor([0.0, 1.0, 0.0]).expand(a.shape)
    ortho = _cross(a, ex)
    use_alt = torch.linalg.vector_norm(ortho, dim=-1, keepdim=True) < 1e-6
    ortho = torch.where(use_alt, _cross(a, ey), ortho)
    q_pi = torch.cat([torch.zeros_like(d), ortho], dim=-1)
    q = torch.where(d < (-1.0 + 1e-9), q_pi, q)
    return quat_normalize(q)


def pose_compose(qvec: torch.Tensor, tvec: torch.Tensor) -> torch.Tensor:
    """(qvec, tvec) -> 3x4 projection matrix [R | t], qvec normalized
    first (``ComposeProjectionMatrix``, reference ``src/base/pose.cc``)."""
    R = quat_to_rotmat(quat_normalize(qvec))
    return torch.cat([R, tvec[..., :, None]], dim=-1)


def pose_inverse(qvec: torch.Tensor, tvec: torch.Tensor):
    """Invert a world->camera pose. Returns (qvec_inv, tvec_inv)."""
    q_inv = quat_conjugate(quat_normalize(qvec))
    return q_inv, -quat_rotate(q_inv, tvec)


def projection_center(qvec: torch.Tensor, tvec: torch.Tensor
                      ) -> torch.Tensor:
    """Camera centre in world coordinates: C = -R^T t."""
    return -quat_rotate(quat_conjugate(quat_normalize(qvec)), tvec)


def pose_relative(q1: torch.Tensor, t1: torch.Tensor, q2: torch.Tensor,
                  t2: torch.Tensor):
    """Relative pose taking camera-1 frame to camera-2 frame: (q21, t21)."""
    q21 = quat_multiply(q2, quat_conjugate(quat_normalize(q1)))
    return q21, t2 - quat_rotate(q21, t1)


def rotmat_angular_distance(R1: torch.Tensor, R2: torch.Tensor
                            ) -> torch.Tensor:
    """Angle (radians) of the relative rotation R1 R2^T. (..., 3, 3) x2 ->
    (...)."""
    tr = torch.einsum("...ij,...kj->...ik", R1, R2).diagonal(
        dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def cayley_to_rotmat(c: torch.Tensor) -> torch.Tensor:
    """Cayley parameters (..., 3) -> rotation matrices (..., 3, 3):
    R = ((1 - |c|^2) I + 2 c c^T + 2 [c]_x) / (1 + |c|^2), the P6L
    solver's rotation unknowns (``absolute_pose.cc:64-75``)."""
    c0, c1, c2 = c[..., 0], c[..., 1], c[..., 2]
    n2 = c0 * c0 + c1 * c1 + c2 * c2
    m = torch.stack(
        [
            1 + c0 * c0 - c1 * c1 - c2 * c2, 2 * (c0 * c1 - c2),
            2 * (c1 + c0 * c2),
            2 * (c2 + c0 * c1), 1 - c0 * c0 + c1 * c1 - c2 * c2,
            2 * (c1 * c2 - c0),
            2 * (c0 * c2 - c1), 2 * (c0 + c1 * c2),
            1 - c0 * c0 - c1 * c1 + c2 * c2,
        ],
        dim=-1,
    ).reshape(c.shape[:-1] + (3, 3))
    return m / (1.0 + n2)[..., None, None]
