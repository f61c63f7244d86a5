"""YAML config system preserving the pcdet config surface.

Mirrors the behavior of the reference config layer (reference:
pcdet/config.py:15-90): a dict-with-attribute-access config tree, loaded from
YAML with recursive ``_BASE_CONFIG_`` inheritance and dotted-path CLI
overrides with type coercion.
"""

from __future__ import annotations

import copy

import yaml


class ConfigDict(dict):
    """dict with attribute access (the reference uses EasyDict)."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return ConfigDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(ConfigDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, ConfigDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def merge_new_config(config: ConfigDict, new_config: dict) -> ConfigDict:
    """Recursive merge with ``_BASE_CONFIG_`` expansion.

    Matches reference pcdet/config.py:50-67: the base config is loaded first,
    then ``new_config`` entries override it key-by-key (dicts merge
    recursively; everything else replaces). A dict merges into a new section
    too, so a nested ``_BASE_CONFIG_`` (``DATA_CONFIG``'s in the shipped
    radar_distill yamls) is expanded, as the reference's is; the JAX
    package's copy leaves it unexpanded. A base's own nested bases are not
    (the reference updates with the base as loaded).
    """
    if "_BASE_CONFIG_" in new_config:
        base_path = new_config.pop("_BASE_CONFIG_")
        with open(base_path) as f:
            base = yaml.safe_load(f)
        config.update(ConfigDict(base))

    for key, val in new_config.items():
        if isinstance(val, dict):
            if not isinstance(config.get(key), dict):
                config[key] = ConfigDict()
            merge_new_config(config[key], val)
        else:
            config[key] = copy.deepcopy(ConfigDict._wrap(val))
    return config


def log_config_to_file(cfg: ConfigDict, pre="cfg", logger=None):
    for key, val in cfg.items():
        if isinstance(val, ConfigDict):
            if logger:
                logger.info(f"----------- {pre}.{key} -----------")
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
        elif logger:
            logger.info(f"{pre}.{key}: {val}")
