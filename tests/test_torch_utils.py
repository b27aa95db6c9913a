"""The port's host utilities (wdbx_tpu_torch.utils) on the CPU.

The cases of ``tests/test_utils.py`` run on the port — data ingestion,
security, config loader, logging, visualization — with the visualizer on
the CPU (``device="cpu"``, or a store built with it). No case is left
out. Then parity with the JAX package's PCA, held on its subspace (the
start blocks come from other random streams): the explained variance of
each component within 1e-3 relative, |cos| >= 0.999 between the leading
components, on stretched corpora."""

import json
import logging

import numpy as np
import pytest

from wdbx_tpu_torch.utils.config_loader import load_config, save_config
from wdbx_tpu_torch.utils.data_utils import (
    chunk_text,
    load_vectors_from_csv,
    load_vectors_from_jsonl,
    normalize_vector,
    parse_vector,
)
from wdbx_tpu_torch.utils.logging import (
    ProgressLogger,
    configure_logging,
    get_logger,
)
from wdbx_tpu_torch.utils.security import WDBXSecurity


class TestDataUtils:
    def test_parse_vector_formats(self):
        expected = np.asarray([1.0, 2.5, -3.0], np.float32)
        for raw in (
            "[1, 2.5, -3]",
            "1,2.5,-3",
            "1 2.5 -3",
            "[1. 2.5 -3.]",
            [1, 2.5, -3],
            {"vector": [1, 2.5, -3]},
            expected,
        ):
            np.testing.assert_allclose(parse_vector(raw), expected)

    def test_parse_vector_invalid(self):
        with pytest.raises(ValueError):
            parse_vector({"no_vector": 1})
        with pytest.raises(ValueError):
            parse_vector(42)

    def test_csv_loader(self, tmp_path):
        path = tmp_path / "data.csv"
        path.write_text(
            'id,vector,tag,score\nv1,"[1,0]",news,3\nv2,"[0,1]",blog,4\n'
        )
        vectors, metadata = load_vectors_from_csv(str(path))
        assert set(vectors) == {"v1", "v2"}
        np.testing.assert_allclose(vectors["v1"], [1, 0])
        assert metadata["v1"] == {"tag": "news", "score": 3}

    def test_jsonl_loader(self, tmp_path):
        path = tmp_path / "data.jsonl"
        rows = [
            {"id": "a", "vector": [1, 0], "metadata": {"x": 1}},
            {"id": "b", "vector": [0, 1], "extra": "y"},
        ]
        path.write_text("\n".join(json.dumps(r) for r in rows))
        vectors, metadata = load_vectors_from_jsonl(str(path))
        assert metadata["a"] == {"x": 1}
        assert metadata["b"] == {"extra": "y"}

    def test_chunk_text_overlap(self):
        text = "word " * 300
        chunks = chunk_text(text, chunk_size=100, overlap=20)
        assert len(chunks) > 10
        assert all(len(c) <= 100 for c in chunks)
        # overlap: consecutive chunks share content
        assert chunks[0][-10:] in chunks[0]

    def test_chunk_text_edge_cases(self):
        assert chunk_text("") == []
        assert chunk_text("short", chunk_size=100, overlap=10) == ["short"]
        with pytest.raises(ValueError):
            chunk_text("x", chunk_size=10, overlap=10)

    def test_normalize_vector(self):
        out = normalize_vector([3, 4])
        np.testing.assert_allclose(out, [0.6, 0.8])
        np.testing.assert_array_equal(normalize_vector([0, 0]), [0, 0])


class TestSecurity:
    def test_password_roundtrip(self):
        sec = WDBXSecurity("secret")
        hashed = sec.hash_password("hunter2")
        assert sec.verify_password("hunter2", hashed)
        assert not sec.verify_password("wrong", hashed)
        assert not sec.verify_password("hunter2", "garbage")

    def test_token_lifecycle(self):
        sec = WDBXSecurity("secret")
        token = sec.generate_token("user1", roles=["reader"])
        payload = sec.verify_token(token)
        assert payload["user_id"] == "user1"
        assert sec.revoke_token(token)
        assert sec.verify_token(token) is None
        assert not sec.revoke_token(token)  # already revoked

    def test_token_expiry(self):
        sec = WDBXSecurity("secret")
        token = sec.generate_token("u", expiry=-1)
        assert sec.verify_token(token) is None

    def test_token_tamper_rejected(self):
        sec = WDBXSecurity("secret")
        token = sec.generate_token("u")
        payload_b64, sig = token.split(".")
        assert sec.verify_token(payload_b64 + ".AAAA") is None
        other = WDBXSecurity("different-secret")
        assert other.verify_token(token) is None

    def test_access_policies(self):
        sec = WDBXSecurity("secret")
        sec.set_policy("reader", ["vectors:read"])
        assert sec.check_access({"roles": ["reader"]}, "vectors:read")
        assert not sec.check_access({"roles": ["reader"]}, "vectors:write")
        assert sec.check_access({"roles": ["admin"]}, "anything")

    def test_encryption_roundtrip(self):
        sec = WDBXSecurity("secret")
        assert sec.decrypt(sec.encrypt("hello")) == b"hello"

    def test_metadata_field_encryption(self):
        sec = WDBXSecurity("secret")
        meta = {"public": 1, "private": {"ssn": "123"}}
        enc = sec.encrypt_metadata(meta, ["private"])
        assert enc["public"] == 1
        assert "_encrypted" in enc["private"]
        dec = sec.decrypt_metadata(enc)
        assert dec == meta


class TestConfigLoader:
    def test_yaml_flatten(self, tmp_path):
        path = tmp_path / "cfg.yaml"
        path.write_text(
            "core:\n  vector_dimension: 128\nindexing:\n  ivf:\n    nlist: 64\n"
        )
        flat = load_config(str(path))
        assert flat["CORE_VECTOR_DIMENSION"] == 128
        assert flat["INDEXING_IVF_NLIST"] == 64

    def test_json_flatten(self, tmp_path):
        path = tmp_path / "cfg.json"
        path.write_text(json.dumps({"api": {"port": 9999}}))
        assert load_config(str(path))["API_PORT"] == 9999

    def test_round_trip(self, tmp_path):
        flat = {"VECTOR_STORE_THREADS": 4, "API_PORT": 8000, "RANDOM_KEY": 1}
        out = tmp_path / "out.yaml"
        save_config(flat, str(out))
        back = load_config(str(out))
        assert back["VECTOR_STORE_THREADS"] == 4
        assert back["API_PORT"] == 8000
        assert back["CORE_RANDOM_KEY"] == 1

    def test_missing_file_raises(self):
        with pytest.raises(FileNotFoundError):
            load_config("/does/not/exist.yaml")


class TestLogging:
    def test_configure_and_context(self, tmp_path):
        configure_logging("DEBUG", log_file=str(tmp_path / "log.txt"))
        logger = get_logger("test", context={"req": "abc"})
        logger.info("message")  # should not raise

    def test_progress_logger(self, caplog):
        logger = logging.getLogger("progress-test")
        with caplog.at_level(logging.INFO, logger="progress-test"):
            with ProgressLogger(logger, total=10, operation="op") as p:
                for _ in range(10):
                    p.update()
        text = caplog.text
        assert "starting" in text and "done" in text and "items/s" in text


class TestVisualization:
    def test_pca_reduce_shape(self, rng):
        from wdbx_tpu_torch.utils.visualization import VectorVisualizer

        viz = VectorVisualizer(device="cpu")
        vecs = rng.standard_normal((50, 16)).astype(np.float32)
        out = viz.reduce(vecs, method="pca", components=2)
        assert out.shape == (50, 2)
        # PCA captures the dominant direction of variance
        stretched = vecs.copy()
        stretched[:, 0] *= 50
        out2 = viz.reduce(stretched, method="pca", components=1)
        corr = np.corrcoef(out2[:, 0], stretched[:, 0])[0, 1]
        assert abs(corr) > 0.95

    def test_scatter_and_heatmap_files(self, rng, tmp_path):
        from wdbx_tpu_torch.utils.visualization import VectorVisualizer

        viz = VectorVisualizer(device="cpu")
        vecs = rng.standard_normal((20, 8)).astype(np.float32)
        p1 = viz.scatter_plot(vecs, output_path=str(tmp_path / "s.png"))
        p2 = viz.similarity_matrix(
            vecs, labels=[f"v{i}" for i in range(20)],
            output_path=str(tmp_path / "h.png"),
        )
        import os

        assert os.path.getsize(p1) > 0 and os.path.getsize(p2) > 0

    def test_db_integration(self, rng, temp_dir, tmp_path):
        from wdbx_tpu_torch import WDBX
        from wdbx_tpu_torch.utils.visualization import VectorVisualizer

        db = WDBX(vector_dimension=8, data_dir=temp_dir, enable_plugins=False,
                  device="cpu")
        for i in range(12):
            db.vector_store(
                rng.standard_normal(8).astype(np.float32), {"i": i}
            )
        viz = VectorVisualizer(db)
        out = viz.save_dashboard(str(tmp_path / "dash.png"))
        import os

        assert os.path.getsize(out) > 0


@pytest.mark.parametrize("d,components", [(16, 2), (64, 3)])
def test_pca_subspace_matches_jax(d, components):
    """Same seeded corpus through both packages' PCA: the explained
    variance of each component within 1e-3 relative of JAX's, and the
    leading components parallel (|cos| >= 0.999). The corpus is
    stretched along a few axes so the leading components are well
    separated."""
    import jax.numpy as jnp
    import torch

    from wdbx_tpu.utils.visualization import _device_pca as jax_pca
    from wdbx_tpu_torch.utils.visualization import _device_pca

    rng = np.random.default_rng(d)
    x = rng.standard_normal((400, d)).astype(np.float32)
    x[:, :4] *= np.asarray([40.0, 20.0, 10.0, 5.0], np.float32)
    x = x @ np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    rj, qj = (np.asarray(a) for a in jax_pca(jnp.asarray(x),
                                             components=components))
    rt, qt = (a.numpy() for a in _device_pca(torch.from_numpy(x),
                                             components=components))
    assert rt.shape == rj.shape == (400, components)
    np.testing.assert_allclose(rt.var(axis=0), rj.var(axis=0), rtol=1e-3)
    cos = np.abs(np.sum(qt * qj, axis=0))
    assert (cos >= 0.999).all(), cos
    np.testing.assert_allclose(qt.T @ qt, np.eye(components), atol=1e-5)


def test_visualizer_device_follows_the_store(temp_dir):
    """With a store attached the reductions run on the store's device;
    with neither a store nor a device they want the card."""
    import torch

    from wdbx_tpu_torch import WDBX
    from wdbx_tpu_torch.utils.visualization import VectorVisualizer

    db = WDBX(vector_dimension=8, data_dir=temp_dir, enable_plugins=False,
              device="cpu")
    assert VectorVisualizer(db)._device() == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VectorVisualizer().reduce(np.ones((4, 8), np.float32))
