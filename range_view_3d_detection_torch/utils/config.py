"""Hydra-compatible config composition (counterpart of the JAX
``utils/config.py``; no hydra, omegaconf or PyYAML).

It composes the ``conf/`` tree as the JAX package does:

- ``defaults`` lists with ``- base``, ``- /model: name``,
  ``- override /dataset: name``, and ``- _self_`` ordering.
- ``# @package _global_`` headers (group configs merged at the root).
- ``${a.b.c}`` interpolation (resolved after composition), including
  relative ``${..sibling}`` references and ``${oc.env:VAR}``.
- CLI dotted-path overrides: ``key.sub=value`` / ``++key.sub=value``.

Files and override values are read by ``utils/yaml_subset.py``, which
gives what ``yaml.safe_load`` gives on the subset of YAML that ``conf/``
uses and raises outside it.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from range_view_3d_detection_torch.utils import yaml_subset

_INTERP = re.compile(r"\$\{([^{}]+)\}")


# ---------------------------------------------------------------------------
# Basic dict utilities
# ---------------------------------------------------------------------------


def deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def set_path(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def get_path(cfg: Dict[str, Any], dotted: str) -> Any:
    node: Any = cfg
    for k in dotted.split("."):
        if isinstance(node, dict):
            node = node[k]
        elif isinstance(node, (list, tuple)):
            node = node[int(k)]
        else:
            raise KeyError(dotted)
    return node


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


def _load_yaml(path: Path) -> Tuple[Dict[str, Any], bool]:
    text = path.read_text()
    is_global = "@package _global_" in text.splitlines()[0] if text else False
    if not is_global:
        for line in text.splitlines()[:3]:
            if "@package _global_" in line:
                is_global = True
                break
    data = yaml_subset.load(text) or {}
    return data, is_global


def _parse_defaults_entry(entry):
    """Normalize a defaults entry -> ('self'|'same'|'group', key, val, override)."""
    if entry == "_self_":
        return ("self", None, None, False)
    if isinstance(entry, str):
        return ("same", None, entry, False)
    (key, val), = entry.items()
    key = str(key)
    override = key.startswith("override ")
    key = key.removeprefix("override ").strip()
    return ("group", key.lstrip("/"), val, override)


def _collect_selections(
    conf_dir: Path,
    group: Optional[str],
    name: str,
    selections: Dict[str, str],
) -> None:
    """Phase 1 (Hydra semantics): walk the whole defaults tree gathering the
    final group selections; ``override`` entries anywhere win over ``???``
    requirements declared upstream. Iterated to fixpoint by the caller."""
    path = conf_dir / (Path(group) / f"{name}.yaml" if group else f"{name}.yaml")
    data, _ = _load_yaml(path)
    for entry in data.get("defaults", []):
        kind, key, val, override = _parse_defaults_entry(entry)
        if kind == "self":
            continue
        if kind == "same":
            _collect_selections(conf_dir, group, val, selections)
            continue
        if key.startswith("hydra"):
            continue
        if val not in ("???", None):
            if override or key not in selections:
                selections[key] = str(val)
        chosen = selections.get(key)
        if chosen is not None:
            _collect_selections(conf_dir, key, chosen, selections)


def _compose_file(
    conf_dir: Path,
    group: Optional[str],
    name: str,
    selections: Dict[str, str],
) -> Dict[str, Any]:
    """Phase 2: compose one config file with its (resolved) defaults list."""
    path = conf_dir / (Path(group) / f"{name}.yaml" if group else f"{name}.yaml")
    data, is_global = _load_yaml(path)
    defaults = data.pop("defaults", [])

    composed: Dict[str, Any] = {}
    self_done = False

    def merge_self():
        nonlocal composed, self_done
        composed = deep_merge(composed, _package(data, group, is_global))
        self_done = True

    for entry in defaults:
        kind, key, val, _override = _parse_defaults_entry(entry)
        if kind == "self":
            merge_self()
        elif kind == "same":
            composed = deep_merge(
                composed, _compose_file(conf_dir, group, val, selections)
            )
        elif not key.startswith("hydra"):
            chosen = selections.get(key)
            if chosen is None:
                raise KeyError(f"config group '{key}' requires a selection")
            composed = deep_merge(
                composed, _compose_file(conf_dir, key, chosen, selections)
            )
    if not self_done:
        merge_self()
    return composed


def _package(
    data: Dict[str, Any], group: Optional[str], is_global: bool
) -> Dict[str, Any]:
    """Place a group config at its package path (root if @_global_)."""
    if is_global or group is None:
        return data
    # Non-global group files are packaged under the group name, matching
    # Hydra's default package (e.g. dataset/av2.yaml -> cfg["dataset"]).
    node: Dict[str, Any] = data
    for part in reversed(group.split("/")):
        node = {part: node}
    return node


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------


def _resolve_ref(ref: str, root: Dict[str, Any], here: List[str]) -> Any:
    ref = ref.strip()
    if ref.startswith("oc.env:"):
        return os.environ.get(ref.split(":", 1)[1], "")
    if ref.startswith("."):
        # Relative reference (OmegaConf): one dot = the containing node,
        # each additional dot walks one level up.
        dots = len(ref) - len(ref.lstrip("."))
        up = dots - 1
        base = here[: len(here) - up] if up else list(here)
        ref = ".".join(base + [ref.lstrip(".")]) if ref.lstrip(".") else ".".join(base)
    return get_path(root, ref)


def _interpolate(node: Any, root: Dict[str, Any], here: List[str]) -> Any:
    if isinstance(node, dict):
        return {
            k: _interpolate(v, root, here + [k]) for k, v in node.items()
        }
    if isinstance(node, list):
        return [_interpolate(v, root, here) for v in node]
    if isinstance(node, str):
        full = _INTERP.fullmatch(node.strip())
        if full:
            val = _resolve_ref(full.group(1), root, here[:-1])
            return _interpolate(val, root, here[:-1])

        def sub(m):
            v = _resolve_ref(m.group(1), root, here[:-1])
            return str(v)

        if _INTERP.search(node):
            return _INTERP.sub(sub, node)
    return node


def resolve_interpolations(cfg: Dict[str, Any], max_passes: int = 8) -> Dict[str, Any]:
    out = cfg
    for _ in range(max_passes):
        new = _interpolate(out, out, [])
        if new == out:
            return new
        out = new
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def flatten(cfg: Dict[str, Any], parent_key: str = "") -> Dict[str, Any]:
    """Flatten a nested config for hparam logging
    (``utils/hydra.py::flatten`` parity, 13-38)."""
    out: Dict[str, Any] = {}
    for k, v in cfg.items():
        key = f"{parent_key}.{k}" if parent_key else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def parse_value(text: str) -> Any:
    """An override's value, read as the YAML subset reads a scalar or a
    flow collection."""
    return yaml_subset.load(text)


def compose(
    conf_dir: str | Path,
    experiment: str,
    overrides: Optional[List[str]] = None,
) -> Dict[str, Any]:
    """Compose ``conf/config.yaml`` with an experiment + CLI overrides.

    Mirrors ``python scripts/train.py experiment=rv-av2 ++k=v``.
    """
    conf_dir = Path(conf_dir)
    selections = {"experiment": experiment}
    # Phase 1: resolve the defaults tree (iterate to fixpoint — overrides
    # discovered late can unlock ??? groups encountered earlier).
    for _ in range(4):
        before = dict(selections)
        _collect_selections(conf_dir, None, "config", selections)
        if selections == before:
            break
    cfg = _compose_file(conf_dir, None, "config", selections)

    for ov in overrides or []:
        ov = ov.lstrip("+")
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must be key=value")
        key, val = ov.split("=", 1)
        if key == "experiment":
            continue
        set_path(cfg, key, parse_value(val))

    return resolve_interpolations(cfg)
