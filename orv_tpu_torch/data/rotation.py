"""Euler <-> rotation-matrix conversions (ZYX composition R = Rz @ Ry @ Rx)
for relative end-effector actions, in numpy f64.

Counterpart of `orv_tpu/data/rotation.py`.
"""

from __future__ import annotations

import numpy as np


def euler2rotm(euler: np.ndarray) -> np.ndarray:
    """[..., 3] (x, y, z) angles -> [..., 3, 3] with R = Rz(z) @ Ry(y) @ Rx(x)."""
    euler = np.asarray(euler, dtype=np.float64)
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    R = np.empty(euler.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = cz * cy
    R[..., 0, 1] = cz * sy * sx - sz * cx
    R[..., 0, 2] = cz * sy * cx + sz * sx
    R[..., 1, 0] = sz * cy
    R[..., 1, 1] = sz * sy * sx + cz * cx
    R[..., 1, 2] = sz * sy * cx - cz * sx
    R[..., 2, 0] = -sy
    R[..., 2, 1] = cy * sx
    R[..., 2, 2] = cy * cx
    return R


def rotm2euler(R: np.ndarray) -> np.ndarray:
    """[..., 3, 3] -> [..., 3] (x, y, z) in (-pi, pi], gimbal-safe."""
    R = np.asarray(R, dtype=np.float64)
    sy = np.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = np.where(singular, np.arctan2(-R[..., 1, 2], R[..., 1, 1]),
                 np.arctan2(R[..., 2, 1], R[..., 2, 2]))
    y = np.arctan2(-R[..., 2, 0], sy)
    z = np.where(singular, 0.0, np.arctan2(R[..., 1, 0], R[..., 0, 0]))
    out = np.stack([x, y, z], axis=-1)
    out = np.where(out > np.pi, out - 2 * np.pi, out)  # wrap to (-pi, pi]
    out = np.where(out <= -np.pi, out + 2 * np.pi, out)
    return out


def relative_actions(
    arm_states: np.ndarray,  # [T, 6] xyz + euler
    gripper_states: np.ndarray,  # [T]
    accumulate: bool = False,
) -> np.ndarray:
    """[T] states -> [T-1, 7] relative actions: each action expresses frame k
    in the frame of frame k-1 (step-wise) or of frame 0 (accumulate)."""
    T = arm_states.shape[0]
    xyz = arm_states[:, 0:3]
    rotm = euler2rotm(arm_states[:, 3:6])  # [T, 3, 3]
    if accumulate:
        ref_xyz = np.broadcast_to(xyz[0], (T - 1, 3))
        ref_rotm = np.broadcast_to(rotm[0], (T - 1, 3, 3))
    else:
        ref_xyz = xyz[:-1]
        ref_rotm = rotm[:-1]
    rel_xyz = np.einsum("tij,tj->ti", ref_rotm.transpose(0, 2, 1), xyz[1:] - ref_xyz)
    rel_rotm = np.einsum("tij,tjk->tik", ref_rotm.transpose(0, 2, 1), rotm[1:])
    rel_rpy = rotm2euler(rel_rotm)
    action = np.zeros((T - 1, 7), dtype=np.float64)
    action[:, 0:3] = rel_xyz
    action[:, 3:6] = rel_rpy
    action[:, 6] = gripper_states[1:]
    return action
