"""Python-file config loader with mmcv semantics (a copy of
``openpsg_tpu/core/config.py``; the port imports nothing of the JAX package).

Config files are plain Python modules evaluated for their top-level names:

  * ``_base_``          — list/str of parent config files, deep-merged
  * ``_delete_``        — in a child dict: drop the parent's keys first
  * ``custom_imports``  — modules to import; the port's configs name the
    port's own modules (``openpsg_tpu_torch/configs/psg/``)

A file is executed in an isolated namespace (never on ``sys.path``) and
the result wrapped in an attribute-access dict.
"""

from __future__ import annotations

import importlib
import os
import pprint
import re
import types
from typing import Any, Dict

_DELETE_KEY = "_delete_"


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value):
        self[name] = value

    def __delattr__(self, name: str):
        del self[name]

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj

    def to_dict(self) -> Dict[str, Any]:
        def _unwrap(obj):
            if isinstance(obj, dict):
                return {k: _unwrap(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(_unwrap(v) for v in obj)
            return obj

        return _unwrap(self)


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    with open(filename, "r", encoding="utf-8") as f:
        source = f.read()
    code = compile(source, filename, "exec")
    mod = types.ModuleType("_openpsg_cfg")
    mod.__file__ = filename
    exec(code, mod.__dict__)
    return {
        k: v
        for k, v in vars(mod).items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
    }


def _merge(base: Any, child: Any) -> Any:
    """Deep-merge child over base with ``_delete_`` semantics."""
    if isinstance(child, dict):
        child = dict(child)
        if child.pop(_DELETE_KEY, False) or not isinstance(base, dict):
            return {k: _merge(None, v) for k, v in child.items()}
        out = dict(base)
        for k, v in child.items():
            out[k] = _merge(base.get(k), v)
        return out
    return child


def import_modules(module_names, allow_failed_imports: bool = False):
    """mmcv ``custom_imports``: import each named module."""
    imported = []
    for name in module_names or []:
        try:
            imported.append(importlib.import_module(name))
        except ImportError:
            if not allow_failed_imports:
                raise
            imported.append(None)
    return imported


class Config:
    """Loaded configuration. ``Config.fromfile(path)`` mirrors mmcv."""

    def __init__(self, cfg_dict: Dict[str, Any], filename: str = ""):
        self._cfg = ConfigDict.wrap(cfg_dict)
        self.filename = filename

    @classmethod
    def fromfile(cls, filename: str, import_custom_modules: bool = True) -> "Config":
        filename = os.path.abspath(os.path.expanduser(filename))
        cfg = cls(cls._load(filename), filename)
        if import_custom_modules and "custom_imports" in cfg:
            ci = cfg.custom_imports
            import_modules(ci.get("imports", []),
                           allow_failed_imports=ci.get("allow_failed_imports", False))
        return cfg

    @classmethod
    def _load(cls, filename: str) -> Dict[str, Any]:
        cfg_dict = _exec_pyfile(filename)
        base = cfg_dict.pop("_base_", None)
        if base is None:
            return cfg_dict
        if isinstance(base, str):
            base = [base]
        merged: Dict[str, Any] = {}
        for b in base:
            merged = _merge(merged, cls._load(os.path.join(os.path.dirname(filename), b)))
        return _merge(merged, cfg_dict)

    def merge_from_dict(self, options: Dict[str, Any]) -> None:
        """CLI ``--cfg-options a.b.c=v`` deep merge."""
        nested: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = nested
            keys = full_key.split(".")
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = v
        self._cfg = ConfigDict.wrap(_merge(self._cfg.to_dict(), nested))

    # -- dict-ish surface -------------------------------------------------
    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("filename",):
            raise AttributeError(name)
        return getattr(self._cfg, name)

    def __getitem__(self, name: str):
        return self._cfg[name]

    def __contains__(self, name: str) -> bool:
        return name in self._cfg

    def get(self, name: str, default=None):
        return self._cfg.get(name, default)

    def setdefault(self, name: str, default=None):
        return self._cfg.setdefault(name, default)

    def __setattr__(self, name: str, value):
        if name.startswith("_") or name in ("filename",):
            object.__setattr__(self, name, value)
        else:
            self._cfg[name] = value

    def to_dict(self) -> Dict[str, Any]:
        return self._cfg.to_dict()

    def dump(self, path: str) -> None:
        """Write as a Python config file (``name = repr``; configs are
        plain data), which :meth:`fromfile` reads back."""
        with open(path, "w", encoding="utf-8") as f:
            for k, v in self._cfg.to_dict().items():
                f.write(f"{k} = {pprint.pformat(v, width=100)}\n")


def replace_cfg_vals(cfg: Config) -> Config:
    """mmdet's ``${key.path}`` interpolation: a string that IS one
    ``${...}`` reference becomes the referenced value (any type); embedded
    references substitute their ``str()``.  References resolve against the
    root config."""
    pattern = re.compile(r"\$\{([^}]+)\}")
    root = cfg.to_dict()

    def lookup(path: str):
        cur: Any = root
        for part in path.split("."):
            cur = cur[part]
        return cur

    def walk(obj):
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(v) for v in obj)
        if isinstance(obj, str):
            full = pattern.fullmatch(obj)
            if full:
                return lookup(full.group(1))
            return pattern.sub(lambda m: str(lookup(m.group(1))), obj)
        return obj

    return Config(walk(root), filename=cfg.filename)


def update_data_root(cfg: Config) -> Config:
    """mmdet's ``MMDET_DATASETS`` override: when the environment variable is
    set, every string containing ``cfg.data_root`` is rewritten onto the new
    root, and ``data_root`` itself replaced.  No-op without the variable or
    a ``data_root`` key."""
    dst = os.environ.get("MMDET_DATASETS")
    src = cfg.get("data_root")
    if not dst or not isinstance(src, str) or not src:
        return cfg
    dst = dst if dst.endswith("/") else dst + "/"
    src_norm = src if src.endswith("/") else src + "/"

    def walk(obj):
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(v) for v in obj)
        if isinstance(obj, str):
            return obj.replace(src_norm, dst).replace(src.rstrip("/"), dst.rstrip("/"))
        return obj

    return Config(walk(cfg.to_dict()), filename=cfg.filename)
