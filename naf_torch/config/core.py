"""Config-group composition (Hydra-semantics subset), the port's own copy of
``naf_tpu/config/core.py``. It reads the repository's ``config/`` YAMLs.

Mirrors the reference config system (config/base.yaml:1-8 defaults list;
custom resolvers hydra_plugins/resolvers.py:6-41; `key=value` CLI
overrides, docs/TRAINING.md:5-9). Supported:

- `defaults:` list entries: `- base` (compose another root), `- group: opt`
  (load config/group/opt.yaml into cfg[group]), `- group@key: opt` (load into
  cfg[key]), `- override group: opt`, `- _self_` (ordering marker; own keys
  always win).
- interpolation `${a.b}`, resolvers `${get_feature:...}`,
  `${get_patch_size:...}`, `${now:FMT}`.
- overrides: `group=option` (swap a config group) or `a.b.c=value`.

There is no `instantiate`: the configs' `_target_`s name the JAX package, so
the port builds its objects from the keys itself.
"""

from __future__ import annotations

import copy
import datetime
import os
import re
from typing import Any, Iterable, Optional

import yaml

__all__ = ["load_config", "get_feature", "get_patch_size"]


def get_feature(target: str) -> int:
    """Backbone name -> embedding dim (hydra_plugins/resolvers.py:6-20)."""
    name = target.lower()
    if "vits" in name or "small" in name:
        return 384
    if "vitb" in name or "base" in name or name == "radio_v2.5-b":
        return 768
    if "vitl" in name or "large" in name or name == "radio_v2.5-l":
        return 1024
    if "tiny" in name:
        return 192
    return 0


def get_patch_size(target: str) -> int:
    """Backbone name -> patch size (hydra_plugins/resolvers.py:23-37)."""
    name = target.lower()
    if "franca" in name:
        return 14
    m = re.search(r"patch(\d+)", name)
    return int(m.group(1)) if m else 16


_RESOLVERS = {
    "get_feature": get_feature,
    "get_patch_size": get_patch_size,
    "now": lambda fmt: datetime.datetime.now().strftime(fmt),
}


def _deep_merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _load_group_option(config_dir: str, group: str, option: str) -> dict:
    """Load config/<group>/<option>.yaml, resolving its own `defaults` list
    (plain strings reference sibling options in the same group)."""
    raw = _load_yaml(os.path.join(config_dir, group, f"{option}.yaml"))
    defaults = raw.pop("defaults", [])
    base: dict = {}
    for entry in defaults:
        if entry == "_self_":
            continue
        if isinstance(entry, str):
            base = _deep_merge(base, _load_group_option(config_dir, group, entry))
    return _deep_merge(base, raw)


def _compose(config_dir: str, name: str) -> dict:
    raw = _load_yaml(os.path.join(config_dir, f"{name}.yaml"))
    defaults = raw.pop("defaults", [])
    cfg: dict = {}
    for entry in defaults:
        if entry == "_self_":
            continue
        if isinstance(entry, str):
            cfg = _deep_merge(cfg, _compose(config_dir, entry))
            continue
        (key, option), = entry.items()
        key = key.replace("override ", "")
        if "@" in key:
            group, target = key.split("@")
        else:
            group = target = key
        sub = _load_group_option(config_dir, group, option)
        cfg[target] = sub
    return _deep_merge(cfg, raw)


def _parse_value(text: str):
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _apply_overrides(cfg: dict, overrides: Iterable[str], config_dir: str) -> dict:
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        group_path = os.path.join(config_dir, key, f"{value}.yaml")
        if "." not in key and os.path.exists(group_path):
            cfg[key] = _load_group_option(config_dir, key, value)
            continue
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(value)
    return cfg


_INTERP = re.compile(r"\$\{([^${}]+)\}")


def _lookup(cfg: dict, dotted: str):
    node: Any = cfg
    for p in dotted.split("."):
        node = node[p]
    return node


def _resolve_str(cfg: dict, s: str, depth: int = 0):
    if depth > 16:
        raise ValueError(f"interpolation loop at {s!r}")

    def sub_inner(text):
        def repl(m):
            expr = m.group(1)
            if ":" in expr:
                fn, arg = expr.split(":", 1)
                arg = sub_inner(arg)
                return str(_RESOLVERS[fn](arg))
            return str(_lookup(cfg, expr))

        return _INTERP.sub(repl, text)

    m = _INTERP.fullmatch(s)
    if m and ":" not in m.group(1):
        val = _lookup(cfg, m.group(1))  # keep non-string types
        if isinstance(val, str):
            return _resolve_str(cfg, val, depth + 1)
        return val
    out = s
    while _INTERP.search(out):
        new = sub_inner(out)
        if new == out:
            break
        out = new
        depth += 1
        if depth > 16:
            raise ValueError(f"interpolation loop at {s!r}")
    return _parse_value(out) if out != s else s


def _resolve(cfg: dict, node):
    if isinstance(node, dict):
        return {k: _resolve(cfg, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(cfg, v) for v in node]
    if isinstance(node, str):
        return _resolve_str(cfg, node)
    return node


def load_config(
    name: str,
    overrides: Iterable[str] = (),
    config_dir: Optional[str] = None,
) -> dict:
    """Compose `config/{name}.yaml` with group defaults + CLI overrides."""
    if config_dir is None:
        config_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "config"
        )
    cfg = _compose(config_dir, name)
    cfg = _apply_overrides(cfg, overrides, config_dir)
    return _resolve(cfg, cfg)
