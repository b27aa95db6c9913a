"""Configuration system.

Behavioral parity with the reference's ``WDBXConfig`` (reference
wdbx/core/config.py:14): a flat uppercase keyspace with precedence
**defaults < JSON config file < environment (``WDBX_*``) < runtime
dict**, type-inferred env values (JSON → bool words → int → float → str,
reference wdbx/core/config.py:129-156), checked typed access
(reference wdbx/core/config.py:215-265), dict-style dunders, and
``get_source`` provenance (reference wdbx/core/config.py:296-310).

Defaults are re-keyed for the device engines (slab dtypes, IVF geometry,
mesh axes) while keeping the reference's knob names where the concept
survives (``VECTOR_DIMENSION``, ``NUM_SHARDS``, ``IVF_NLIST`` ~
``FAISS_NLIST``...).
"""

from __future__ import annotations

import json
import os
from typing import Any

DEFAULTS: dict[str, Any] = {
    # core
    "VECTOR_DIMENSION": 384,
    "NUM_SHARDS": 1,
    "DATA_DIR": "./wdbx_data",
    "LOG_LEVEL": "INFO",
    # vector store
    "VECTOR_STORE_SAVE_IMMEDIATELY": False,
    "VECTOR_STORE_AUTOSAVE_INTERVAL": 1000,  # reference autosave cadence
    # index
    "INDEX_TYPE": "flat",  # flat | ivf
    "INDEX_METRIC": "cosine",  # cosine | ip
    "INDEX_DTYPE": "float32",  # float32 | bfloat16 | int8 | int4
    "RERANK_FETCH_FACTOR": None,  # None = auto (2 int8, 20 int4)
    "INDEX_CAPACITY": 1024,
    # ivf (FAISS_NLIST/NPROBE analogues, reference wdbx/core/config.py:36-37)
    "IVF_NLIST": 100,
    "IVF_NPROBE": 8,
    "IVF_TRAIN_THRESHOLD": 4096,
    "IVF_REBUILD_FRACTION": 0.2,
    "IVF_ASSIGNMENTS": 1,  # 2 = SOAR-style spilled assignment
    "IVF_BACKGROUND_REBUILD": False,  # optimize() without blocking reads
    "IVF_RECYCLE_HOLES": True,  # reuse deleted rows' bucket-matched slots
    # parallel / mesh
    "MESH_AXIS": "shard",
    "MESH_REPLICAS": 1,  # >1 = (replica, shard) mesh, batch shards over replicas
    "MESH_AUTO_REMESH": False,  # heal() re-stripes onto surviving devices
    "DISTRIBUTED_ENABLED": False,
    "DISTRIBUTED_REPLICATION_FACTOR": 1,
    "DISTRIBUTED_HOST": "localhost",
    "DISTRIBUTED_PORT": 9090,
    # api
    "API_HOST": "127.0.0.1",
    "API_PORT": 8000,
    "API_KEY": None,
    "API_CORS_ORIGINS": None,
    # plugins
    "PLUGINS_ENABLED": True,
    "OLLAMA_HOST": "http://localhost:11434",
    "OLLAMA_MODEL": "llama2",
    "OLLAMA_EMBEDDING_MODEL": "all-MiniLM-L6-v2",
    "OLLAMA_TIMEOUT": 30,
    "LMSTUDIO_HOST": "localhost",
    "LMSTUDIO_PORT": 1234,
    "LMSTUDIO_TIMEOUT": 60,
    # security
    "SECURITY_SECRET_KEY": None,
    "SECURITY_TOKEN_EXPIRY": 3600,
}

_BOOL_WORDS = {"true": True, "yes": True, "on": True, "1": True,
               "false": False, "no": False, "off": False, "0": False}


def _infer(value: str) -> Any:
    """Type-infer an env string: JSON, then bool words, int, float, str."""
    try:
        return json.loads(value)
    except (ValueError, TypeError):
        pass
    low = value.strip().lower()
    if low in _BOOL_WORDS:
        return _BOOL_WORDS[low]
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


#: section-qualified YAML keys → flat config keys
_SECTION_MAP = {
    "CORE_": "",
    "INDEXING_IVF_": "IVF_",
    # reference-config compat (reference wdbx/core/config.py:27-47 and
    # config/wdbx_config.yaml): keep the reference's indexing.hnsw.* /
    # indexing.faiss.* knobs addressable as flat HNSW_*/FAISS_* keys —
    # create_index translates them onto the device engines
    "INDEXING_HNSW_": "HNSW_",
    "INDEXING_FAISS_": "FAISS_",
    "INDEXING_": "INDEX_",
    "ENABLE_PLUGINS": "PLUGINS_ENABLED",
    "ENABLE_DISTRIBUTED": "DISTRIBUTED_ENABLED",
    "API_AUTH_KEY": "API_KEY",
    "PARALLEL_MESH_AXIS": "MESH_AXIS",
    "PARALLEL_REPLICAS": "MESH_REPLICAS",
    "PARALLEL_AUTO_REMESH": "MESH_AUTO_REMESH",
    "PARALLEL_REPLICATION_FACTOR": "DISTRIBUTED_REPLICATION_FACTOR",
    "PLUGINS_ENABLED": "PLUGINS_ENABLED",
    "PLUGINS_": "",
}


def _map_section_key(key: str) -> str:
    for prefix, repl in _SECTION_MAP.items():
        if key == prefix:
            return repl
        if key.startswith(prefix) and prefix.endswith("_"):
            return repl + key[len(prefix):]
    return key


class WDBXConfig:
    """Flat key-value config with provenance tracking."""

    ENV_PREFIX = "WDBX_"

    def __init__(
        self,
        config: dict[str, Any] | None = None,
        config_file: str | None = None,
    ):
        self._values: dict[str, Any] = dict(DEFAULTS)
        self._sources: dict[str, str] = {k: "default" for k in DEFAULTS}
        if config_file:
            self._load_file(config_file)
        self._load_env()
        if config:
            for key, val in config.items():
                self._set(key.upper(), val, "runtime")

    def _set(self, key: str, value: Any, source: str) -> None:
        # reference-spelling aliases apply at EVERY source (env vars and
        # runtime dicts too, not just YAML files): an operator setting
        # WDBX_API_AUTH_KEY must not end up serving unauthenticated
        # because only API_KEY is read back
        key = _map_section_key(key)
        self._values[key] = value
        self._sources[key] = source

    def _load_file(self, path: str) -> None:
        if not os.path.exists(path):
            return
        with open(path) as f:
            data = json.load(f)
        for key, val in data.items():
            self._set(key.upper(), val, "file")

    def _load_env(self) -> None:
        for key, val in os.environ.items():
            if key.startswith(self.ENV_PREFIX):
                self._set(key[len(self.ENV_PREFIX):], _infer(val), "env")

    # -- access -------------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        return self._values.get(key.upper(), default)

    def set(self, key: str, value: Any) -> None:
        self._set(key.upper(), value, "runtime")

    def get_typed(self, key: str, type_: type, default: Any = None) -> Any:
        """Checked coercion, incl. list/dict from JSON or CSV strings
        (parity: reference wdbx/core/config.py:215-265)."""
        value = self.get(key, default)
        if value is None:
            return default
        if isinstance(value, type_) and not (
            type_ is bool and not isinstance(value, bool)
        ):
            return value
        try:
            if type_ is bool:
                if isinstance(value, str):
                    low = value.strip().lower()
                    if low in _BOOL_WORDS:
                        return _BOOL_WORDS[low]
                    raise ValueError(value)
                return bool(value)
            if type_ is list:
                if isinstance(value, str):
                    try:
                        parsed = json.loads(value)
                        if isinstance(parsed, list):
                            return parsed
                    except ValueError:
                        pass
                    return [v.strip() for v in value.split(",") if v.strip()]
                return list(value)
            if type_ is dict:
                if isinstance(value, str):
                    parsed = json.loads(value)
                    if isinstance(parsed, dict):
                        return parsed
                    raise ValueError(value)
                return dict(value)
            return type_(value)
        except (ValueError, TypeError):
            return default

    @classmethod
    def from_file(cls, path: str, **overrides: Any) -> "WDBXConfig":
        """Build a config from a hierarchical YAML/JSON file (the
        config/wdbx_config.yaml shape): sections flatten via
        utils/config_loader and map onto the flat keyspace
        (``core.vector_dimension`` → ``VECTOR_DIMENSION``,
        ``indexing.ivf.nlist`` → ``IVF_NLIST``, ...)."""
        from wdbx_tpu_torch.utils.config_loader import load_config

        flat = load_config(path)
        # File values slot in at "file" precedence (defaults < file <
        # env < runtime) — passing them as the runtime dict would let
        # the file silently override environment variables.
        cfg = cls({k.upper(): v for k, v in overrides.items()})
        for key, value in flat.items():
            mapped = _map_section_key(key)
            if cfg._sources.get(mapped) in (None, "default"):
                cfg._set(mapped, value, "file")
        return cfg

    def get_source(self, key: str) -> str | None:
        return self._sources.get(key.upper())

    def to_dict(self) -> dict[str, Any]:
        return dict(self._values)

    # -- dunders --------------------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._values[key.upper()]

    def __setitem__(self, key: str, value: Any) -> None:
        self.set(key, value)

    def __contains__(self, key: str) -> bool:
        return key.upper() in self._values

    def __iter__(self):
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __repr__(self) -> str:
        return f"WDBXConfig({len(self._values)} keys)"
