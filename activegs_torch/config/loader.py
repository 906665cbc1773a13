"""Config system: YAML groups plus dotted command-line overrides (port of
`activegs_tpu/config/loader.py`).

`main.yaml` names one file of each group (planner, mapper, simulator,
scene); `group=choice` picks another, and `a.b.c=value` sets one key.
The files are the port's own copies (this directory) and are read, like
the override values, by `yaml_subset`. `build_components` maps the loaded
tree onto the port's typed configs.
"""

from __future__ import annotations

import copy
import os
from typing import Any

from . import yaml_subset

_CONF_DIR = os.path.dirname(__file__)


class ConfigNode(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj

    def to_dict(self):
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml_subset.loads(f.read()) or {}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def load_config(name: str = "main", overrides: list[str] | None = None, conf_dir: str = _CONF_DIR) -> ConfigNode:
    """The config `<conf_dir>/<name>.yaml` with its groups merged in and the
    `key=value` overrides applied: `group=choice` re-selects a group file,
    a dotted key sets one value (parsed as YAML)."""
    overrides = list(overrides or [])
    root = _load_yaml(os.path.join(conf_dir, f"{name}.yaml"))
    defaults = root.pop("defaults", {})

    # group re-selection overrides (group=choice) apply to defaults first
    rest = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if key in defaults and "." not in key:
            defaults[key] = val
        else:
            rest.append(ov)

    cfg: dict = {}
    for group, choice in defaults.items():
        group_cfg = _load_yaml(os.path.join(conf_dir, group, f"{choice}.yaml"))
        cfg[group] = _merge(cfg.get(group, {}), group_cfg)
    cfg = _merge(cfg, root)

    for ov in rest:
        key, _, val = ov.partition("=")
        _set_dotted(cfg, key, yaml_subset.value(val))
    return ConfigNode.wrap(cfg)


def build_components(cfg: ConfigNode) -> dict:
    """Typed configs from the loaded tree: {"map_cfg", "voxel_cfg",
    "raster_cfg", "planner_cfg"}, with the reference's values field for
    field. Keys the reference's `build_components` does not read are
    ignored here too (`sparse_ratio`, `sampler_type`, `bilateral_radius`,
    and `raster` keys other than tile_h, tile_w, max_dup and bf16_pairs);
    the TPU-only `unroll_views` and `raster.interpret` are taken and
    dropped. `resample_per_step`, which the reference's loader never reads
    (so there it stays False), is read here with that default."""
    from ..mapping.gaussians import MapConfig
    from ..mapping.voxel_map import VoxelConfig
    from ..planning.planner import PlannerConfig
    from ..render.types import RasterConfig

    g = cfg.mapper.gaussian_map
    map_cfg = MapConfig(
        capacity=g.get("capacity", 1 << 19),
        bound=tuple(g.bound),
        background=tuple(g.background)[:3],
        error_thres=g.error_thres,
        scale_factor=g.scale_factor,
        optimization_steps=g.optimization_steps,
        prune_interval=g.prune_interval,
        use_view_distribution=g.use_view_distribution,
        batch_size=g.sampler.batch_size,
        active_size=g.sampler.active_size,
        mean_lr=g.optimizer.mean_lr,
        rotation_lr=g.optimizer.rotation_lr,
        opacity_lr=g.optimizer.opacity_lr,
        scale_lr=g.optimizer.scale_lr,
        harmonic_lr=g.optimizer.harmonic_lr,
        resample_per_step=g.get("resample_per_step", False),
    )
    v = cfg.mapper.voxel_map
    voxel_cfg = VoxelConfig(
        map_resolution=tuple(v.map_resolution),
        safety_margin=v.safety_margin,
        min_gaussian_per_voxel=v.min_gaussian_per_voxel,
    )
    r = cfg.mapper.get("raster", {})
    raster_cfg = RasterConfig(
        tile_h=r.get("tile_h", RasterConfig.tile_h),
        tile_w=r.get("tile_w", RasterConfig.tile_w),
        max_dup=r.get("max_dup", 4),
        bf16_pairs=r.get("bf16_pairs", RasterConfig.bf16_pairs),
    )
    p = cfg.planner
    planner_cfg = PlannerConfig(
        type=p.type,
        radius=p.radius,
        robot_size=p.robot_size,
        pitch_angle=p.pitch_angle,
        sample_num=p.sample_num,
        max_roi_sample_num=p.max_roi_sample_num,
        use_confidence=p.use_confidence,
        path_length_factor=p.path_length_factor,
        render_ratio=p.get("render_ratio", 0.25),
        explore_weight=p.get("explore_weight", 1000.0),
        init_pose=tuple(tuple(row) for row in p.init_pose),
    )
    return {
        "map_cfg": map_cfg,
        "voxel_cfg": voxel_cfg,
        "raster_cfg": raster_cfg,
        "planner_cfg": planner_cfg,
    }
