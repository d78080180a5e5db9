"""Rotation conversions for the Simpler env adapters and the SimplerLite
envs, host-side numpy (counterpart of the JAX package's
``utils/geometry.py``; reference src/utils/geometry.py, which vendors
transforms3d).

Conventions, as the adapters use them:
  - Euler angles: 'sxyz' (static/extrinsic x-y-z), the transforms3d default
  - Quaternions: w-x-y-z order (transforms3d convention)
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_EPS = np.finfo(np.float64).eps * 4.0


def euler2mat(ai: float, aj: float, ak: float) -> np.ndarray:
    """sxyz euler -> 3x3 rotation matrix: R = Rz(ak) @ Ry(aj) @ Rx(ai)."""
    si, ci = math.sin(ai), math.cos(ai)
    sj, cj = math.sin(aj), math.cos(aj)
    sk, ck = math.sin(ak), math.cos(ak)
    rx = np.array([[1, 0, 0], [0, ci, -si], [0, si, ci]])
    ry = np.array([[cj, 0, sj], [0, 1, 0], [-sj, 0, cj]])
    rz = np.array([[ck, -sk, 0], [sk, ck, 0], [0, 0, 1]])
    return rz @ ry @ rx


def mat2euler(mat: np.ndarray) -> Tuple[float, float, float]:
    """3x3 rotation matrix -> sxyz euler (ai, aj, ak)."""
    m = np.asarray(mat, dtype=np.float64)[:3, :3]
    cy = math.sqrt(m[2, 2] * m[2, 2] + m[2, 1] * m[2, 1])
    if cy > _EPS:
        ai = math.atan2(m[2, 1], m[2, 2])
        aj = math.atan2(-m[2, 0], cy)
        ak = math.atan2(m[1, 0], m[0, 0])
    else:  # gimbal lock: pitch = +-pi/2
        ai = math.atan2(-m[1, 2], m[1, 1])
        aj = math.atan2(-m[2, 0], cy)
        ak = 0.0
    return ai, aj, ak


def quat2mat(q: np.ndarray) -> np.ndarray:
    """quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    if n < _EPS:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def mat2quat(mat: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> quaternion [w, x, y, z] (w >= 0)."""
    m = np.asarray(mat, dtype=np.float64)[:3, :3]
    t = np.trace(m)
    if t > 0:
        r = math.sqrt(1.0 + t)
        s = 0.5 / r
        q = np.array(
            [0.5 * r, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
             (m[1, 0] - m[0, 1]) * s]
        )
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = math.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        s = 0.5 / r
        q = np.empty(4)
        q[0] = (m[k, j] - m[j, k]) * s
        q[1 + i] = 0.5 * r
        q[1 + j] = (m[j, i] + m[i, j]) * s
        q[1 + k] = (m[k, i] + m[i, k]) * s
    return q if q[0] >= 0 else -q


def euler2quat(ai: float, aj: float, ak: float) -> np.ndarray:
    return mat2quat(euler2mat(ai, aj, ak))


def quat2euler(q: np.ndarray) -> Tuple[float, float, float]:
    return mat2euler(quat2mat(q))


def quat2axangle(q: np.ndarray) -> Tuple[np.ndarray, float]:
    """quaternion [w, x, y, z] -> (unit axis, angle in [0, 2pi))."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q)
    w = np.clip(q[0], -1.0, 1.0)
    angle = 2.0 * math.acos(w)
    s = math.sqrt(1.0 - w * w)
    if s < _EPS:
        return np.array([1.0, 0.0, 0.0]), 0.0
    return q[1:] / s, angle


def euler2axangle(ai: float, aj: float, ak: float) -> Tuple[np.ndarray, float]:
    """sxyz euler -> (unit axis, angle) (reference adapters' rotation
    post-processing, simpler.py:132)."""
    return quat2axangle(euler2quat(ai, aj, ak))


def axangle2mat(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    C = 1 - c
    return np.array(
        [
            [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
        ]
    )


def isrotation(m: np.ndarray, atol: float = 1e-6) -> bool:
    m = np.asarray(m, dtype=np.float64)
    return (
        m.shape == (3, 3)
        and np.allclose(m @ m.T, np.eye(3), atol=atol)
        and abs(np.linalg.det(m) - 1.0) < atol
    )
