"""Viewpoint sampling + camera-path generation, host-side numpy (the port's
own copy of `activegs_tpu/planning/paths.py`).

Cone-constrained viewpoint sampling around ROI voxels, random in-place
rotations, Bezier position curves with SLERP'd view directions. These run
on the host once per planning step.
"""

from __future__ import annotations

import numpy as np
from scipy.special import comb


def rotation_from_z(z: np.ndarray) -> np.ndarray:
    """No-roll camera rotations from view directions (z axes), batched
    (`rotation_from_z_batch`, `planning/utils.py:228-259`)."""
    z = np.atleast_2d(z).astype(np.float64)
    z = z / np.linalg.norm(z, axis=-1, keepdims=True)
    down = np.array([0.0, 0.0, -1.0])
    collinear = np.abs(np.abs(z @ down) - 1.0) < 1e-6
    x = np.cross(np.broadcast_to(down, z.shape), z)
    x[collinear] = [1.0, 0.0, 0.0]
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(z, x)
    y = y / np.linalg.norm(y, axis=-1, keepdims=True)
    return np.stack([x, y, z], axis=-1)


def random_rotation(n: int, pitch_angle=None, rng=None) -> np.ndarray:
    """Random view orientations, optionally at a fixed pitch
    (`random_rotation`, `utils/operations.py:124-141`). Returns OpenCV
    camera rotations whose z axis is the view direction."""
    rng = rng or np.random.default_rng()
    dirs = rng.normal(size=(n, 3))
    dirs /= np.clip(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-8, None)
    if pitch_angle is not None:
        xy = np.linalg.norm(dirs[:, :2], axis=1, keepdims=True)
        dirs = np.concatenate([dirs[:, :2], xy * np.tan(pitch_angle)], axis=1)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return rotation_from_z(dirs)


def inplace_rotation(points: np.ndarray, pitch_angle=None, rng=None) -> np.ndarray:
    """Poses at given positions with random orientations
    (`inplace_rotation`, `planning/utils.py:55-59`)."""
    points = np.atleast_2d(points)
    n = len(points)
    ts = np.tile(np.eye(4), (n, 1, 1))
    ts[:, :3, 3] = points
    ts[:, :3, :3] = random_rotation(n, pitch_angle, rng)
    return ts.astype(np.float32)


def select_points_within_cone(
    point: np.ndarray,
    normal: np.ndarray,
    free_points: np.ndarray,
    d_close: float = 0.3,
    d_far: float = 2.0,
    cosine_sim: float = 0.5,
    pitch_angle=None,
):
    """Free-space positions inside the viewing cone of an ROI voxel, with
    view directions pointing at it (`select_points_within_cone`,
    `planning/utils.py:9-47`)."""
    vec = point[None] - free_points
    dist = np.linalg.norm(vec, axis=-1)
    dist_ok = (dist >= d_close) & (dist <= d_far)
    views = vec / np.clip(dist[:, None], 1e-8, None)
    if pitch_angle is not None:
        xy = np.linalg.norm(views[:, :2], axis=1, keepdims=True)
        views = np.concatenate(
            [views[:, :2], xy * np.tan(pitch_angle)], axis=1
        )
        views /= np.clip(np.linalg.norm(views, axis=1, keepdims=True), 1e-8, None)
    nn = normal / max(np.linalg.norm(normal), 1e-12)
    angle_ok = np.sum(views * -nn, axis=1) >= cosine_sim
    mask = dist_ok & angle_ok
    return free_points[mask], views[mask]


def cone_masks_batch(
    points: np.ndarray,
    normals: np.ndarray,
    free_points: np.ndarray,
    d_close: float = 0.3,
    d_far: float = 2.0,
    cosine_sim: float = 0.5,
    pitch_angle=None,
):
    """`select_points_within_cone` for a BATCH of ROI voxels at once:
    identical per-ROI masks/views, computed as one (R, F) broadcast instead
    of R separate O(F) passes. Returns (mask (R, F) bool, views (R, F, 3))."""
    points = np.atleast_2d(points)
    vec = points[:, None, :] - free_points[None]  # (R, F, 3)
    dist = np.linalg.norm(vec, axis=-1)
    dist_ok = (dist >= d_close) & (dist <= d_far)
    views = vec / np.clip(dist[..., None], 1e-8, None)
    if pitch_angle is not None:
        xy = np.linalg.norm(views[..., :2], axis=-1, keepdims=True)
        views = np.concatenate(
            [views[..., :2], xy * np.tan(pitch_angle)], axis=-1
        )
        views /= np.clip(np.linalg.norm(views, axis=-1, keepdims=True), 1e-8, None)
    nn = normals / np.clip(
        np.linalg.norm(normals, axis=-1, keepdims=True), 1e-12, None
    )
    angle_ok = np.einsum("rfc,rc->rf", views, -nn) >= cosine_sim
    return dist_ok & angle_ok, views


def bezier_curve(control_points: np.ndarray, num_points: int = 100) -> np.ndarray:
    """(`bezier_curve`, `planning/utils.py:262-270`)."""
    control_points = np.asarray(control_points, np.float64)
    n = len(control_points) - 1
    t = np.linspace(0.0, 1.0, num_points)
    curve = np.zeros((num_points, control_points.shape[1]))
    for i in range(n + 1):
        curve += np.outer(
            comb(n, i) * (t**i) * ((1 - t) ** (n - i)), control_points[i]
        )
    return curve


def slerp(v1: np.ndarray, v2: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(`slerp`, `planning/utils.py:288-312`)."""
    v1 = v1 / np.linalg.norm(v1)
    v2 = v2 / np.linalg.norm(v2)
    theta = np.arccos(np.clip(v1 @ v2, -1.0, 1.0))
    if theta < 1e-3:
        return np.tile(v2, (len(t), 1))
    t = t[:, None]
    out = (np.sin((1 - t) * theta) * v1 + np.sin(t * theta) * v2) / np.sin(theta)
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


def wp2path(
    start_rotation: np.ndarray,
    goal_rotation: np.ndarray,
    waypoints: np.ndarray,
    distance_thre: float = 0.05,
    angle_thre: float = 0.1,
):
    """Waypoints -> dense camera path: Bezier positions + SLERP view
    directions at 5 cm / 0.1 rad steps (`wp2path`,
    `planning/utils.py:315-346`). Returns (path (S, 4, 4), length)."""
    waypoints = np.atleast_2d(np.asarray(waypoints, np.float64))
    v1 = start_rotation[:, 2]
    v2 = goal_rotation[:, 2]
    angle = np.arccos(np.clip(np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2)), -1, 1))
    n_angle = int(np.ceil(angle / angle_thre))

    if len(waypoints) == 1:
        path_length = 0.0
        num = max(n_angle, 1)
        positions = np.tile(waypoints[-1], (num, 1))
    else:
        diffs = waypoints[1:] - waypoints[:-1]
        path_length = float(np.sum(np.linalg.norm(diffs, axis=1)))
        n_xyz = int(np.ceil(path_length / distance_thre))
        num = max(n_xyz, n_angle, 2)
        positions = bezier_curve(waypoints, num_points=num)

    t = np.linspace(0.0, 1.0, num)
    dirs = slerp(v1, v2, t)
    rots = rotation_from_z(dirs)
    path = np.tile(np.eye(4), (num, 1, 1))
    path[:, :3, 3] = positions
    path[:, :3, :3] = rots
    return path.astype(np.float32), path_length


def cal_flight_time(path_length: float, flight_speed: float = 1.0) -> float:
    """Constant-velocity flight model (`planning/utils.py:50-52`)."""
    return path_length / flight_speed
