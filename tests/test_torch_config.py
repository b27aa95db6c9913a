"""The cases of ``tests/test_config.py`` on the port, on the CPU.

A translated copy of that file: the same classes, functions,
parametrisations and asserts, run on ``wdbx_tpu_torch``. Each
``wdbx_tpu`` import names its ``wdbx_tpu_torch`` counterpart; the
autouse fixture asks for the CPU through
``test_torch_ops.port_on_cpu`` (the default device and mesh of one
test), so the package keeps the card as its own default.

Translated, every case (13 cases):
TestConfig: test_defaults, test_runtime_overrides,
test_env_pickup_and_inference,
test_precedence_runtime_beats_env_beats_file, test_get_typed_coercion,
test_dict_dunders, test_json_file_load; TestFromFile:
test_yaml_sections_map_to_flat_keys, test_overrides_win,
test_canonical_repo_config_loads; TestReferenceConfigCompat:
test_reference_yaml_verbatim, test_hnsw_index_type_alias,
test_faiss_index_type_alias.

Changed beyond the imports and the fixture, one line:
``TestReferenceConfigCompat.REF_YAML`` finds the reference project's
checkout through ``WDBX_REFERENCE_TREE`` where the reference names a
fixed path of its own host. Left out: nothing. As in the reference,
``test_reference_yaml_verbatim`` skips where that tree is not present.

The reference file's description:

Config system tests (parity spec: reference tests/test_core.py:57-88).
"""

import json
import os

import numpy as np
import pytest

from wdbx_tpu_torch.core.config import WDBXConfig
from test_torch_ops import port_on_cpu


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    port_on_cpu(monkeypatch)


class TestConfig:
    def test_defaults(self):
        cfg = WDBXConfig()
        assert cfg.get("VECTOR_DIMENSION") == 384
        assert cfg.get("NUM_SHARDS") == 1
        assert cfg.get("INDEX_TYPE") == "flat"
        assert cfg.get_source("VECTOR_DIMENSION") == "default"

    def test_runtime_overrides(self):
        cfg = WDBXConfig({"vector_dimension": 128, "CUSTOM_KEY": "x"})
        assert cfg.get("VECTOR_DIMENSION") == 128
        assert cfg.get("CUSTOM_KEY") == "x"
        assert cfg.get_source("VECTOR_DIMENSION") == "runtime"

    def test_env_pickup_and_inference(self, monkeypatch):
        monkeypatch.setenv("WDBX_VECTOR_DIMENSION", "512")
        monkeypatch.setenv("WDBX_SOME_FLAG", "true")
        monkeypatch.setenv("WDBX_SOME_FLOAT", "0.5")
        monkeypatch.setenv("WDBX_SOME_LIST", "[1, 2, 3]")
        monkeypatch.setenv("WDBX_SOME_STR", "hello world")
        cfg = WDBXConfig()
        assert cfg.get("VECTOR_DIMENSION") == 512
        assert cfg.get("SOME_FLAG") is True
        assert cfg.get("SOME_FLOAT") == 0.5
        assert cfg.get("SOME_LIST") == [1, 2, 3]
        assert cfg.get("SOME_STR") == "hello world"
        assert cfg.get_source("VECTOR_DIMENSION") == "env"

    def test_precedence_runtime_beats_env_beats_file(self, monkeypatch, tmp_path):
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"A": "file", "B": "file", "C": "file"}))
        monkeypatch.setenv("WDBX_A", "env")
        monkeypatch.setenv("WDBX_B", "env")
        cfg = WDBXConfig({"A": "runtime"}, config_file=str(path))
        assert cfg.get("A") == "runtime"
        assert cfg.get("B") == "env"
        assert cfg.get("C") == "file"

    def test_get_typed_coercion(self):
        cfg = WDBXConfig(
            {"N": "42", "F": "2.5", "FLAG": "yes", "L": "a, b,c", "D": '{"x": 1}'}
        )
        assert cfg.get_typed("N", int) == 42
        assert cfg.get_typed("F", float) == 2.5
        assert cfg.get_typed("FLAG", bool) is True
        assert cfg.get_typed("L", list) == ["a", "b", "c"]
        assert cfg.get_typed("D", dict) == {"x": 1}
        assert cfg.get_typed("N", dict, default={"d": 1}) == {"d": 1}
        assert cfg.get_typed("MISSING", int, default=7) == 7

    def test_dict_dunders(self):
        cfg = WDBXConfig()
        cfg["MY_KEY"] = 5
        assert cfg["MY_KEY"] == 5
        assert "MY_KEY" in cfg
        assert "my_key" in cfg  # case-insensitive
        with pytest.raises(KeyError):
            cfg["NOPE"]

    def test_json_file_load(self, tmp_path):
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"VECTOR_DIMENSION": 777}))
        cfg = WDBXConfig(config_file=str(path))
        assert cfg.get("VECTOR_DIMENSION") == 777
        assert cfg.get_source("VECTOR_DIMENSION") == "file"


class TestFromFile:
    def test_yaml_sections_map_to_flat_keys(self, tmp_path):
        path = tmp_path / "cfg.yaml"
        path.write_text(
            "core:\n"
            "  vector_dimension: 128\n"
            "  num_shards: 4\n"
            "indexing:\n"
            "  type: ivf\n"
            "  dtype: bfloat16\n"
            "  ivf:\n"
            "    nlist: 64\n"
            "    nprobe: 4\n"
            "api:\n"
            "  port: 9001\n"
            "parallel:\n"
            "  mesh_axis: shard\n"
            "  replicas: 2\n"
            "  auto_remesh: true\n"
            "  replication_factor: 2\n"
            "plugins:\n"
            "  enabled: false\n"
            "  ollama:\n"
            "    model: mistral\n"
        )
        cfg = WDBXConfig.from_file(str(path))
        assert cfg.get("VECTOR_DIMENSION") == 128
        assert cfg.get("NUM_SHARDS") == 4
        assert cfg.get("INDEX_TYPE") == "ivf"
        assert cfg.get("INDEX_DTYPE") == "bfloat16"
        assert cfg.get("IVF_NLIST") == 64
        assert cfg.get("IVF_NPROBE") == 4
        assert cfg.get("API_PORT") == 9001
        assert cfg.get("MESH_AXIS") == "shard"
        assert cfg.get("MESH_REPLICAS") == 2
        assert cfg.get("MESH_AUTO_REMESH") is True
        assert cfg.get("DISTRIBUTED_REPLICATION_FACTOR") == 2
        assert cfg.get("PLUGINS_ENABLED") is False
        assert cfg.get("OLLAMA_MODEL") == "mistral"

    def test_overrides_win(self, tmp_path):
        path = tmp_path / "cfg.yaml"
        path.write_text("core:\n  vector_dimension: 128\n")
        cfg = WDBXConfig.from_file(str(path), vector_dimension=64)
        assert cfg.get("VECTOR_DIMENSION") == 64

    def test_canonical_repo_config_loads(self):
        cfg = WDBXConfig.from_file("config/wdbx_config.yaml")
        assert cfg.get("VECTOR_DIMENSION") == 384
        assert cfg.get("IVF_NLIST") == 100
        assert cfg.get("INDEX_TYPE") == "flat"


class TestReferenceConfigCompat:
    """The reference's own config file + key spellings must load and
    serve unchanged (reference wdbx/core/config.py:27-47,
    config/wdbx_config.yaml)."""

    #: in the reference project's checkout, named by WDBX_REFERENCE_TREE
    #: ("" where it is unset: no tree)
    REF_YAML = (os.path.join(os.environ["WDBX_REFERENCE_TREE"], "config",
                             "wdbx_config.yaml")
                if os.environ.get("WDBX_REFERENCE_TREE") else "")

    def _serve(self, cfg, tmp_path):
        from wdbx_tpu_torch.core.wdbx import WDBX

        cfg.set("DATA_DIR", str(tmp_path / "data"))
        db = WDBX(vector_dimension=None, num_shards=None, data_dir=None,
                  config=cfg, enable_plugins=False)
        vec = np.random.default_rng(0).standard_normal(
            cfg.get("VECTOR_DIMENSION", 384)
        ).astype(np.float32)
        vid = db.vector_store(list(vec), {"tag": "t"})
        hits = db.vector_search(list(vec), limit=1)
        assert hits and hits[0][0] == vid
        return db

    def test_reference_yaml_verbatim(self, tmp_path):
        if not os.path.exists(self.REF_YAML):
            pytest.skip("reference tree not present")
        cfg = WDBXConfig.from_file(self.REF_YAML)
        assert cfg.get("INDEX_TYPE") == "hnsw"
        assert cfg.get("HNSW_EF_SEARCH") == 50
        assert cfg.get("FAISS_INDEX_TYPE") == "Flat"
        assert cfg.get("PLUGINS_ENABLED") is True
        assert cfg.get("VECTOR_DIMENSION") == 384
        self._serve(cfg, tmp_path)

    def test_hnsw_index_type_alias(self, tmp_path):
        from wdbx_tpu_torch.index import create_index
        from wdbx_tpu_torch.index.clustered import ClusteredIVFIndex

        cfg = WDBXConfig({"INDEX_TYPE": "HNSW", "HNSW_EF_SEARCH": 120})
        idx = create_index(cfg.get("INDEX_TYPE"), 32, cfg)
        assert isinstance(idx, ClusteredIVFIndex)
        assert idx.nprobe == 20  # 120 / 6

    def test_faiss_index_type_alias(self):
        from wdbx_tpu_torch.index import create_index
        from wdbx_tpu_torch.index.flat import FlatIndex
        from wdbx_tpu_torch.index.ivf import IVFIndex

        flat = create_index(
            "faiss", 32, WDBXConfig({"FAISS_INDEX_TYPE": "Flat"})
        )
        assert isinstance(flat, FlatIndex)
        ivf = create_index(
            "faiss", 32,
            WDBXConfig({"FAISS_INDEX_TYPE": "IVF64,Flat",
                        "FAISS_NPROBE": 5}),
        )
        assert isinstance(ivf, IVFIndex)
        assert ivf.nlist == 64 and ivf.nprobe == 5
