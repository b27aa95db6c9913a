"""YAML/JSON config file loading.

Parity with reference wdbx/utils/config_loader.py: flatten nested
YAML/JSON into the flat ``WDBX_SECTION_KEY`` keyspace recursively
(:64-86) and round-trip back to hierarchical YAML/JSON (:119-174). The
canonical file shape is config/wdbx_config.yaml (core, vector_store,
indexing.*, api, plugins.*, security, distributed sections).
"""

from __future__ import annotations

import json
import os
from typing import Any


def _flatten(data: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    flat: dict[str, Any] = {}
    for key, value in data.items():
        name = f"{prefix}_{key}".upper() if prefix else str(key).upper()
        if isinstance(value, dict):
            flat.update(_flatten(value, name))
        else:
            flat[name] = value
    return flat


def load_config(path: str) -> dict[str, Any]:
    """Load a YAML or JSON config file into flat uppercase keys
    (``{"indexing": {"hnsw": {"m": 16}}}`` → ``{"INDEXING_HNSW_M": 16}``)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(f) or {}
        else:
            data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"config root must be a mapping, got {type(data)}")
    return _flatten(data)


def save_config(
    flat: dict[str, Any], path: str, sections: list[str] | None = None
) -> None:
    """Round-trip flat keys back to a hierarchical file. ``sections``
    lists known top-level section names used to split keys (first
    matching prefix wins); unmatched keys go under ``core``."""
    sections = sorted(
        sections
        or ["vector_store", "indexing", "api", "plugins", "security",
            "distributed", "core"],
        key=len,
        reverse=True,
    )
    tree: dict[str, Any] = {}
    for key, value in flat.items():
        lower = key.lower()
        target = None
        for section in sections:
            if lower.startswith(section + "_"):
                target = section
                rest = lower[len(section) + 1:]
                break
        if target is None:
            target, rest = "core", lower
        tree.setdefault(target, {})[rest] = value
    with open(path, "w") as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            yaml.safe_dump(tree, f, default_flow_style=False)
        else:
            json.dump(tree, f, indent=2)
