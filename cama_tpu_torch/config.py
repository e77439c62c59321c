"""Config loading + schema validation, the same schema as main.py's.

A copy of cama_tpu/config.py (which imports cama_tpu.io.scene, and with it
jax when jax is installed) that also accepts this package's own
`cama_configs.device` key.  Same results as the original on the shared
schema (tests/test_torch_host.py).
"""
from __future__ import annotations

import os

from cama_tpu_torch.io.scene import DEFAULT_CAMA_CONFIGS

TOP_LEVEL_KEYS = {
    "version": str,
    "dataroot": str,
    "converted_dataroot": str,
    "scene_names": list,
    "cama_label_file": str,
    "output_video_dir": str,
    "map_classes": list,
    "video_preset": str,
    "batch_scenes": bool,
    "sites": list,
}
REQUIRED = ["converted_dataroot", "scene_names", "output_video_dir"]


class ConfigError(ValueError):
    pass


def validate_config(configs):
    if not isinstance(configs, dict):
        raise ConfigError(f"config must be a mapping, got {type(configs).__name__}")
    for key in REQUIRED:
        if key not in configs:
            raise ConfigError(f"missing required config key: {key!r}")
    for key, typ in TOP_LEVEL_KEYS.items():
        if key in configs and not isinstance(configs[key], typ):
            raise ConfigError(
                f"config key {key!r} must be {typ.__name__}, "
                f"got {type(configs[key]).__name__}"
            )
    if not configs["scene_names"]:
        raise ConfigError("scene_names is empty — nothing to process")
    cama = configs.get("cama_configs") or {}
    if not isinstance(cama, dict):
        raise ConfigError("cama_configs must be a mapping")
    unknown = set(cama) - set(DEFAULT_CAMA_CONFIGS)
    if unknown:
        raise ConfigError(
            f"unknown cama_configs keys: {sorted(unknown)} "
            f"(accepted: {sorted(DEFAULT_CAMA_CONFIGS)})"
        )
    sites = configs.get("sites") or []
    for i, site in enumerate(sites):
        members = normalize_site_entry(site, i, len(sites))["scenes"]
        if not isinstance(members, list) or not members:
            raise ConfigError(
                f"sites[{i}] must be a scene name, a non-empty scene-name "
                "list, or a mapping with a 'scenes' list")
        unknown_scenes = set(members) - set(configs["scene_names"])
        if unknown_scenes:
            raise ConfigError(
                f"sites[{i}] references scenes not in scene_names: "
                f"{sorted(unknown_scenes)}")
    merged = dict(configs)
    merged["cama_configs"] = {**DEFAULT_CAMA_CONFIGS, **cama}
    merged.setdefault("map_classes", ["lane_marking", "Road_teeth", "Crosswalk_Line"])
    return merged


def normalize_site_entry(site_cfg, index, n_sites):
    """Canonical {'name', 'scenes', 'refine'} view of one sites[] entry: a
    scene-name string, a scene-name list, or a mapping.  'scenes' is None
    for uninterpretable entries."""
    default_name = "site" if n_sites == 1 else f"site{index}"
    if isinstance(site_cfg, dict):
        return {"name": site_cfg.get("name", default_name),
                "scenes": site_cfg.get("scenes", []),
                "refine": bool(site_cfg.get("refine", False))}
    if isinstance(site_cfg, str):  # single scene name, not char-split
        return {"name": default_name, "scenes": [site_cfg], "refine": False}
    try:
        scenes = list(site_cfg)
    except TypeError:
        scenes = None
    return {"name": default_name, "scenes": scenes, "refine": False}


def load_config(path):
    """Read and validate a YAML config.  Returns (configs, device or None):
    the port's `cama_configs.device` key is taken out before the shared
    schema check."""
    import yaml

    if not os.path.exists(path):
        raise ConfigError(f"config file not found: {path}")
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    device = None
    if isinstance(raw, dict) and isinstance(raw.get("cama_configs"), dict):
        device = raw["cama_configs"].pop("device", None)
    return validate_config(raw), device
