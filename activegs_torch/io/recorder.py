"""Mission recorder: simulated-time budget accounting + snapshot persistence
(port of `activegs_tpu/io/recorder.py`).

The mission clock is the sum of measured mapping time, measured planning
time and modelled flight time (constant 1 m/s); the mission ends when it
exceeds the budget, and the map is snapshotted every `record_interval`
simulated seconds. Artifacts are numpy / JSON, the reference's files.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import checkpoint


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class MissionRecorder:
    def __init__(self, save_dir: str, budget: float = 300.0, record_interval: float = 60.0,
                 record_rgbd: bool = False, record_global_path: bool = True):
        self.save_dir = save_dir
        self.budget = budget
        self.record_interval = record_interval
        self.record_time = record_interval  # first snapshot threshold
        self.record_rgbd = record_rgbd
        self.record_global_path = record_global_path
        self.time_dict = {"mapping": 0.0, "planning": 0.0, "flight": 0.0}
        self.accum_path_length = 0.0
        self.camera_params_list = []
        self.global_path = []
        os.makedirs(save_dir, exist_ok=True)
        # fresh mission per recorder: a rerun into the same directory must
        # not append to the previous run's snapshot index / telemetry
        for stale in ("step_stats.jsonl", os.path.join("map", "record_info.txt")):
            p = os.path.join(save_dir, stale)
            if os.path.exists(p):
                os.remove(p)

    # ---- budget ----

    @property
    def t_mission(self) -> float:
        return sum(self.time_dict.values())

    @property
    def is_alive(self) -> bool:
        return self.t_mission < self.budget

    def update_time(self, item: str, seconds: float) -> None:
        self.time_dict[item] += seconds

    def update_path(self, path: np.ndarray, path_length: float) -> None:
        self.accum_path_length += float(path_length)
        if self.record_global_path:
            self.global_path.extend(np.asarray(path).tolist())

    @property
    def require_record(self) -> bool:
        if self.t_mission > self.record_time:
            self.record_time += self.record_interval
            return True
        return False

    def log_step_stats(self, stats: dict) -> None:
        """Append per-step mission telemetry (loss, spawn/prune counts,
        binning drop counters, bucket occupancy) to step_stats.jsonl."""
        stats = dict(stats)
        stats["t_mission"] = self.t_mission
        path = os.path.join(self.save_dir, "step_stats.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(stats) + "\n")

    def log(self) -> dict:
        t = max(self.t_mission, 1e-9)
        info = {
            "t_mission": self.t_mission,
            "mapping_pct": 100.0 * self.time_dict["mapping"] / t,
            "planning_pct": 100.0 * self.time_dict["planning"] / t,
            "flight_pct": 100.0 * self.time_dict["flight"] / t,
            "travel_distance": self.accum_path_length,
        }
        print(
            f" mission {info['t_mission']:.1f}s | mapping {info['mapping_pct']:.1f}%"
            f" planning {info['planning_pct']:.1f}% flight {info['flight_pct']:.1f}%"
            f" | travel {info['travel_distance']:.2f} m"
        )
        return info

    # ---- persistence ----

    def save_dataframe(self, frame: dict, frame_index: str) -> None:
        ext = _np(frame["extrinsic"]).reshape(-1)
        intr = _np(frame["intrinsic"]).reshape(-1)
        self.camera_params_list.append(np.concatenate([ext, intr]).tolist())
        if self.record_rgbd:
            d = os.path.join(self.save_dir, "dataframe")
            os.makedirs(os.path.join(d, "rgb"), exist_ok=True)
            os.makedirs(os.path.join(d, "depth"), exist_ok=True)
            np.save(
                os.path.join(d, "rgb", f"{frame_index}.npy"),
                _np(frame["rgb"]),
            )
            np.save(
                os.path.join(d, "depth", f"{frame_index}.npy"),
                _np(frame["depth"]),
            )

    def save_map(self, gm_state, map_cfg, map_index: str) -> None:
        map_dir = os.path.join(self.save_dir, "map")
        os.makedirs(map_dir, exist_ok=True)
        checkpoint.save_gaussian_map(
            os.path.join(map_dir, f"map_{map_index}.npz"), gm_state, map_cfg
        )
        with open(os.path.join(map_dir, f"cameras_{map_index}.json"), "w") as f:
            json.dump(self.camera_params_list, f)
        with open(os.path.join(map_dir, "record_info.txt"), "a") as f:
            f.write(f"{map_index} {self.t_mission} {self.accum_path_length}\n")

    def save_path(self) -> None:
        if self.global_path:
            np.save(
                os.path.join(self.save_dir, "global_path.npy"),
                np.asarray(self.global_path, np.float32),
            )
