"""Component registry: the port's own copy of
`futuredet_tpu/utils/registry.py` (the reference's registry pattern,
`det3d/utils/registry.py`, instances at `det3d/models/registry.py`).

The built-in components are config-driven (config.py), but user code can
register custom detectors/readers/datasets by name and resolve them the same
way the reference's `build_from_cfg` does.
"""
from __future__ import annotations

from typing import Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Callable] = {}

    def register(self, name: str | None = None):
        def deco(fn):
            key = name or fn.__name__
            if key in self._items:
                raise KeyError(f"{key} already registered in {self.name}")
            self._items[key] = fn
            return fn
        return deco

    def get(self, name: str) -> Callable:
        if name not in self._items:
            raise KeyError(
                f"{name} not in registry {self.name}; "
                f"known: {sorted(self._items)}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items


DETECTORS = Registry("detectors")
READERS = Registry("readers")
DATASETS = Registry("datasets")
