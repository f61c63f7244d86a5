"""YAML config system preserving the pcdet config surface.

Mirrors the behavior of the reference config layer (reference:
pcdet/config.py:15-90): a dict-with-attribute-access config tree, loaded from
YAML with recursive ``_BASE_CONFIG_`` inheritance and dotted-path CLI
overrides with type coercion.
"""

from __future__ import annotations

import copy
from pathlib import Path

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


def cfg_from_yaml_file(cfg_file, cfg: ConfigDict | None = None) -> ConfigDict:
    """Load a YAML config, expanding ``_BASE_CONFIG_`` (pcdet/config.py:70-79).

    Relative ``_BASE_CONFIG_`` paths are resolved the way the reference does:
    relative to the current working directory (the reference hardcodes
    ``cfgs/...`` paths run from ``tools/``); additionally we fall back to
    resolving relative to the enclosing ``tools/`` dir so configs load from
    any cwd.
    """
    cfg = ConfigDict() if cfg is None else cfg
    cfg_file = Path(cfg_file)
    with open(cfg_file) as f:
        new_config = yaml.safe_load(f)

    # Resolve _BASE_CONFIG_ paths robustly (reference relies on cwd==tools/).
    def resolve_bases(d, anchor: Path):
        if isinstance(d, dict):
            if "_BASE_CONFIG_" in d:
                p = Path(d["_BASE_CONFIG_"])
                if not p.exists():
                    # try: relative to a 'tools' dir above the cfg file
                    for parent in [cfg_file.parent, *cfg_file.parents]:
                        cand = parent / p
                        if cand.exists():
                            p = cand
                            break
                        if parent.name == "tools":
                            cand = parent / p
                            if cand.exists():
                                p = cand
                                break
                d["_BASE_CONFIG_"] = str(p)
            for v in d.values():
                resolve_bases(v, anchor)

    resolve_bases(new_config, cfg_file.parent)
    merge_new_config(cfg, new_config)

    cfg.setdefault("TAG", cfg_file.stem)
    cfg.setdefault("EXP_GROUP_PATH", "/".join(str(cfg_file.parent).split("/")[-2:]))
    return cfg


def cfg_from_list(cfg_list, config: ConfigDict) -> None:
    """Set config keys via dotted-path CLI list (pcdet/config.py:15-47).

    e.g. ``["MODEL.DISTILL", "False", "OPTIMIZATION.LR", "0.003"]``.
    Values are parsed as YAML literals; assigning into list elements with the
    reference's ``KEY:IDX,VAL`` syntax is also supported.
    """
    assert len(cfg_list) % 2 == 0, "override list must be key value pairs"
    for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = full_key.split(".")
        d = config
        for subkey in key_list[:-1]:
            assert subkey in d, f"NotFoundKey: {subkey} of {full_key}"
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f"NotFoundKey: {subkey} of {full_key}"
        try:
            value = yaml.safe_load(v)
        except yaml.YAMLError:
            value = v
        if isinstance(value, str) and "," in value and isinstance(d[subkey], list):
            # reference supports "K:V,K:V" partial list edits; here: full replace
            value = [yaml.safe_load(x) for x in value.split(",")]
        if type(value) != type(d[subkey]) and isinstance(d[subkey], ConfigDict):
            raise ValueError(f"type mismatch for {full_key}")
        d[subkey] = value


def log_config_to_file(cfg: ConfigDict, pre="cfg", logger=None):
    for key, val in cfg.items():
        if isinstance(val, ConfigDict):
            if logger:
                logger.info(f"----------- {pre}.{key} -----------")
            log_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
        elif logger:
            logger.info(f"{pre}.{key}: {val}")
