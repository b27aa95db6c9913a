"""Data ingestion utilities.

Parity with reference wdbx/utils/data_utils.py: CSV and JSONL bulk
loaders returning ``(vectors, metadata)`` dicts (:16-171), multi-format
``parse_vector`` (JSON array / CSV / whitespace / numpy-repr /
dict-field, :174-231), overlapping ``chunk_text`` for RAG (:234-288),
and ``normalize_vector`` (:291-306).

Torch port: ``wdbx_tpu/utils/data_utils.py`` with its imports repointed to
``wdbx_tpu_torch``; the behaviour is unchanged.
"""

from __future__ import annotations

import csv
import json
import re
from typing import Any

import numpy as np


def load_vectors_from_csv(
    path: str,
    id_column: str = "id",
    vector_column: str = "vector",
    delimiter: str = ",",
) -> tuple[dict[str, np.ndarray], dict[str, dict[str, Any]]]:
    """Load ``{id: vector}`` and ``{id: metadata}`` from a CSV file.
    Non-id, non-vector columns become metadata."""
    vectors: dict[str, np.ndarray] = {}
    metadata: dict[str, dict[str, Any]] = {}
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter=delimiter)
        for i, row in enumerate(reader):
            vid = row.get(id_column) or f"row_{i}"
            raw = row.get(vector_column)
            if raw is None:
                continue
            vectors[vid] = parse_vector(raw)
            metadata[vid] = {
                k: _coerce(v)
                for k, v in row.items()
                if k not in (id_column, vector_column)
            }
    return vectors, metadata


def load_vectors_from_jsonl(
    path: str,
    id_field: str = "id",
    vector_field: str = "vector",
    metadata_field: str | None = "metadata",
) -> tuple[dict[str, np.ndarray], dict[str, dict[str, Any]]]:
    """Load from JSON-lines; metadata comes from ``metadata_field`` if
    present, else all remaining fields."""
    vectors: dict[str, np.ndarray] = {}
    metadata: dict[str, dict[str, Any]] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            vid = str(obj.get(id_field, f"row_{i}"))
            if vector_field not in obj:
                continue
            vectors[vid] = np.asarray(obj[vector_field], np.float32)
            if metadata_field and metadata_field in obj:
                metadata[vid] = dict(obj[metadata_field])
            else:
                metadata[vid] = {
                    k: v
                    for k, v in obj.items()
                    if k not in (id_field, vector_field)
                }
    return vectors, metadata


def parse_vector(raw: Any) -> np.ndarray:
    """Parse a vector from JSON array, CSV string, whitespace-separated
    string, numpy-repr string, or dict with a 'vector' field."""
    if isinstance(raw, np.ndarray):
        return raw.astype(np.float32)
    if isinstance(raw, (list, tuple)):
        return np.asarray(raw, np.float32)
    if isinstance(raw, dict):
        if "vector" in raw:
            return parse_vector(raw["vector"])
        raise ValueError("dict input must contain a 'vector' field")
    if isinstance(raw, str):
        text = raw.strip()
        if text.startswith("[") or text.startswith("("):
            try:
                return np.asarray(json.loads(text), np.float32)
            except json.JSONDecodeError:
                # numpy repr like "[1. 2. 3.]"
                inner = text.strip("[]() \n")
                parts = re.split(r"[\s,]+", inner)
                return np.asarray([float(p) for p in parts if p], np.float32)
        if "," in text:
            return np.asarray(
                [float(p) for p in text.split(",") if p.strip()], np.float32
            )
        return np.asarray(
            [float(p) for p in text.split() if p.strip()], np.float32
        )
    raise ValueError(f"cannot parse vector from {type(raw).__name__}")


def chunk_text(
    text: str, chunk_size: int = 1000, overlap: int = 100
) -> list[str]:
    """Overlapping character chunks, breaking on whitespace where
    possible — the RAG ingestion helper."""
    if chunk_size <= 0:
        raise ValueError("chunk_size must be positive")
    if overlap >= chunk_size:
        raise ValueError("overlap must be smaller than chunk_size")
    text = text.strip()
    if not text:
        return []
    chunks: list[str] = []
    start = 0
    while start < len(text):
        end = min(start + chunk_size, len(text))
        if end < len(text):
            space = text.rfind(" ", start + chunk_size // 2, end)
            if space > start:
                end = space
        chunks.append(text[start:end].strip())
        if end >= len(text):
            break
        start = max(end - overlap, start + 1)
    return [c for c in chunks if c]


def normalize_vector(vector: Any) -> np.ndarray:
    """Host-side unit normalization; zero vectors pass through."""
    arr = np.asarray(vector, np.float32)
    norm = np.linalg.norm(arr)
    if norm < 1e-12:
        return arr
    return arr / norm


def _coerce(value: str) -> Any:
    """Best-effort scalar coercion for CSV metadata cells."""
    if value is None:
        return None
    for cast in (int, float):
        try:
            return cast(value)
        except (ValueError, TypeError):
            pass
    low = str(value).strip().lower()
    if low in ("true", "false"):
        return low == "true"
    return value
