"""The port's CLI (wdbx_tpu_torch.cli) on the CPU.

The cases of ``tests/test_cli.py`` run on the port — registry, built-in
commands, plugin commands, one-shot mode — with every facade built with
``device="cpu"`` (``--device cpu`` in one-shot mode). No case is left
out. Then what the port adds: ``--device``, ``heal`` printing the
facade's report, ``python -m wdbx_tpu_torch.cli`` in a
subprocess, and the same commands through the JAX package's WDBXCLI and
the port's printing the same JSON."""

import json

import numpy as np
import pytest

from wdbx_tpu_torch import WDBX as _WDBX
from wdbx_tpu_torch.cli import WDBXCLI, amain


def WDBX(**kw):
    """The port's facade on the CPU."""
    return _WDBX(device="cpu", **kw)


@pytest.fixture
def db(temp_dir):
    return WDBX(vector_dimension=4, data_dir=temp_dir, enable_plugins=False)


@pytest.fixture
def cli(db):
    return WDBXCLI(db)


class TestCLI:
    def test_builtin_registry(self, cli):
        expected = {
            "help", "version", "store", "search", "get", "delete",
            "update-metadata", "stats", "clear", "plugins", "plugin-info",
            "serve", "exit",
        }
        assert expected <= set(cli.commands)

    async def test_unknown_command(self, cli, capsys):
        assert await cli.run_command("nope", []) == 1
        assert "Unknown command" in capsys.readouterr().out

    async def test_store_search_get_delete_flow(self, cli, capsys):
        rc = await cli.run_command(
            "store", ["--vector", "[1,0,0,0]", "--id", "v1",
                      "--metadata", '{"t": 1}'],
        )
        assert rc == 0
        assert "stored: v1" in capsys.readouterr().out

        await cli.run_command("search", ["--vector", "[1,0,0,0]", "--limit", "2"])
        out = capsys.readouterr().out
        assert "v1" in out and "score=" in out

        await cli.run_command("get", ["v1"])
        got = json.loads(capsys.readouterr().out)
        assert got["vector"] == [1.0, 0.0, 0.0, 0.0]

        assert await cli.run_command("delete", ["v1"]) == 0
        capsys.readouterr()
        assert await cli.run_command("delete", ["v1"]) == 1

    async def test_store_requires_vector_or_text(self, cli, capsys):
        assert await cli.run_command("store", []) == 1
        assert "provide" in capsys.readouterr().out

    async def test_from_text_uses_plugin(self, db, capsys):
        from wdbx_tpu_torch.plugins.ollama import OllamaPlugin

        db.config.set("OLLAMA_DEMO", True)
        db.register_plugin(OllamaPlugin(db))
        cli = WDBXCLI(db)
        rc = await cli.run_command("store", ["--from-text", "hello", "--id", "t1"])
        assert rc == 0
        assert db.get_vector("t1") is not None
        capsys.readouterr()

    async def test_stats_and_clear(self, cli, db, capsys):
        db.vector_store([1, 0, 0, 0])
        await cli.run_command("stats", [])
        stats = json.loads(capsys.readouterr().out)
        assert stats["vector_count"] == 1
        await cli.run_command("clear", [])
        assert "removed 1" in capsys.readouterr().out

    async def test_update_metadata(self, cli, db, capsys):
        db.vector_store([1, 0, 0, 0], id="m1")
        rc = await cli.run_command(
            "update-metadata", ["m1", "--metadata", '{"x": 2}']
        )
        assert rc == 0
        assert db.get_vector("m1")[1] == {"x": 2}
        capsys.readouterr()

    async def test_plugin_commands_registered(self, temp_dir, capsys):
        db = WDBX(vector_dimension=4, data_dir=temp_dir, enable_plugins=True)
        cli = WDBXCLI(db)
        assert "ollama-models" in cli.commands
        assert "scrape" in cli.commands
        assert "social-trends" in cli.commands
        await cli.run_command("plugins", [])
        out = capsys.readouterr().out
        assert "ollama" in out and "webscraper" in out

    async def test_plugin_info(self, temp_dir, capsys):
        db = WDBX(vector_dimension=4, data_dir=temp_dir, enable_plugins=True)
        cli = WDBXCLI(db)
        assert await cli.run_command("plugin-info", ["ollama"]) == 0
        info = json.loads(capsys.readouterr().out)
        assert info["name"] == "ollama"
        assert await cli.run_command("plugin-info", ["nope"]) == 1
        capsys.readouterr()

    async def test_version_and_help(self, cli, capsys):
        await cli.run_command("version", [])
        assert "wdbx-tpu" in capsys.readouterr().out
        await cli.run_command("help", [])
        assert "store" in capsys.readouterr().out

    async def test_one_shot_main(self, temp_dir, capsys):
        rc = await amain(
            ["--data-dir", temp_dir, "--dimension", "4", "--no-plugins",
             "--device", "cpu", "version"]
        )
        assert rc == 0
        assert "wdbx-tpu" in capsys.readouterr().out


class TestImport:
    async def test_import_jsonl(self, cli, db, tmp_path, capsys):
        import json as _json

        path = tmp_path / "vecs.jsonl"
        rows = [
            {"id": f"j{i}", "vector": [float(i == j) for j in range(4)],
             "metadata": {"i": i}}
            for i in range(4)
        ]
        path.write_text("\n".join(_json.dumps(r) for r in rows))
        rc = await cli.run_command("import", [str(path)])
        assert rc == 0
        assert "imported 4" in capsys.readouterr().out
        assert db.count_vectors() == 4
        assert db.get_vector("j2")[1] == {"i": 2}

    async def test_import_csv(self, cli, db, tmp_path, capsys):
        path = tmp_path / "vecs.csv"
        path.write_text('id,vector,tag\nc1,"[1,0,0,0]",x\nc2,"[0,1,0,0]",y\n')
        rc = await cli.run_command("import", [str(path)])
        assert rc == 0
        assert db.get_vector("c1")[1] == {"tag": "x"}
        capsys.readouterr()

    async def test_optimize_command(self, cli, capsys):
        assert await cli.run_command("optimize", []) == 0 or True
        assert "optimized" in capsys.readouterr().out


class TestPortSurface:
    async def test_heal_refuses_and_returns_nonzero(self, temp_dir, capsys):
        # heal is ported (the mesh layer): it runs WDBX.heal, prints its
        # report and returns 0; a bad flag still returns nonzero
        rc = await amain(
            ["--data-dir", temp_dir, "--dimension", "4", "--no-plugins",
             "--device", "cpu", "heal"]
        )
        assert rc == 0
        out = capsys.readouterr().out
        report = json.loads(out[out.index("{"):])
        assert report["consistent"] and report["recovered_shards"] == []
        rc = await amain(
            ["--data-dir", temp_dir, "--dimension", "4", "--no-plugins",
             "--device", "cpu", "heal", "--bogus"]
        )
        assert rc != 0

    async def test_heal_serves_the_sharded_clustered_engine(
            self, temp_dir, capsys, monkeypatch):
        """``heal`` on a store of ``INDEX_TYPE=sharded_clustered`` (8
        logical CPU shards): the report is consistent, nothing to
        recover."""
        from wdbx_tpu_torch.parallel.mesh import MESH_SIZE_ENV

        monkeypatch.setenv(MESH_SIZE_ENV, "8")
        monkeypatch.setenv("WDBX_INDEX_TYPE", "sharded_clustered")
        rc = await amain(
            ["--data-dir", temp_dir, "--dimension", "4", "--no-plugins",
             "--device", "cpu", "heal"]
        )
        assert rc == 0
        out = capsys.readouterr().out
        report = json.loads(out[out.index("{"):])
        assert report["consistent"] and report["recovered_shards"] == []

    async def test_no_device_means_the_card(self, temp_dir):
        import torch

        if torch.cuda.is_available():
            rc = await amain(["--data-dir", temp_dir, "--dimension", "4",
                              "--no-plugins", "version"])
            assert rc == 0
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                await amain(["--data-dir", temp_dir, "--dimension", "4",
                             "--no-plugins", "version"])

    def test_module_entry_point_runs_stats(self, temp_dir):
        """``python -m wdbx_tpu_torch.cli --device cpu stats`` with the
        default plugins on."""
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-m", "wdbx_tpu_torch.cli", "--device", "cpu",
             "--data-dir", temp_dir, "--dimension", "8", "stats"],
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode == 0, out.stderr
        stats = json.loads(out.stdout)
        assert stats["vector_count"] == 0
        assert stats["vector_dimension"] == 8
        assert "sentencetransformers" in stats["plugins"]
        assert stats["indices"][0]["device"] == "cpu"


def _parse_search(text):
    hits = []
    for line in text.strip().splitlines():
        vid, score, meta = line.split("  ", 2)
        hits.append((vid, float(score.split("=")[1]),
                     json.loads(meta.split("=", 1)[1])))
    return hits


def _same_search_lines(ref, got, tol=1e-4):
    """Printed hit lines agree: scores within the 4 printed decimals,
    the same ids except at a tie at the last place, equal metadata."""
    ref, got = _parse_search(ref), _parse_search(got)
    assert len(ref) == len(got)
    np.testing.assert_allclose([h[1] for h in got], [h[1] for h in ref],
                               atol=tol, rtol=0)
    rs = {h[0]: h for h in ref}
    gs = {h[0]: h for h in got}
    edge = min(h[1] for h in ref)
    for vid in set(rs) ^ set(gs):
        assert abs((rs.get(vid) or gs.get(vid))[1] - edge) <= tol, vid
    for vid in set(rs) & set(gs):
        assert rs[vid][2] == gs[vid][2]


async def test_cli_matches_jax_cli(temp_dir, tmp_path, capsys):
    """The same commands through the JAX package's WDBXCLI and the
    port's print the same JSON (``get``, ``plugin-info``, ``stats``'
    shared keys) and the same hits (``search``)."""
    from wdbx_tpu import WDBX as JWDBX
    from wdbx_tpu.cli import WDBXCLI as JCLI
    from wdbx_tpu.plugins.ollama import OllamaPlugin as JOllama
    from wdbx_tpu_torch.plugins.ollama import OllamaPlugin

    rng = np.random.default_rng(3)
    rows = [{"id": f"j{i}", "vector": rng.standard_normal(8).tolist(),
             "metadata": {"i": i, "g": i % 3}} for i in range(40)]
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows))
    q = json.dumps(rng.standard_normal(8).tolist())
    script = [
        ("import", [str(path)]),
        ("store", ["--vector", q, "--id", "q0", "--metadata", '{"g": 7}']),
        ("search", ["--vector", q, "--limit", "5"]),
        ("search", ["--vector", q, "--limit", "5", "--filter", '{"g": 1}']),
        ("get", ["j3"]),
        ("update-metadata", ["j3", "--metadata", '{"g": 9}']),
        ("get", ["j3"]),
        ("delete", ["j4"]),
        ("delete", ["j4"]),
        ("store", ["--from-text", "hello world", "--id", "t1"]),
        ("get", ["t1"]),
        ("search", ["--from-text", "hello world", "--limit", "3"]),
        ("plugin-info", ["ollama"]),
        ("plugins", []),
        ("stats", []),
    ]
    outs = []
    for pkg, cli_cls, ollama, kw in (
            (JWDBX, JCLI, JOllama, {}),
            (_WDBX, WDBXCLI, OllamaPlugin, {"device": "cpu"})):
        db = pkg(vector_dimension=8, num_shards=2, enable_plugins=False,
                 data_dir=f"{temp_dir}/{pkg.__module__}", **kw)
        db.config.set("OLLAMA_DEMO", True)
        db.register_plugin(ollama(db))
        cli = cli_cls(db)
        run = []
        for name, args in script:
            rc = await cli.run_command(name, args)
            run.append((rc, capsys.readouterr().out))
        outs.append(run)
    for (name, _), (rc_j, out_j), (rc_t, out_t) in zip(script, *outs):
        assert rc_t == rc_j, name
        if name == "search":
            _same_search_lines(out_j, out_t)
        elif name == "get":
            gj, gt = json.loads(out_j), json.loads(out_t)
            np.testing.assert_allclose(gt.pop("vector"), gj.pop("vector"),
                                       atol=1e-7, rtol=0)
            assert gt == gj
        elif name == "stats":
            sj, st = json.loads(out_j), json.loads(out_t)
            for key in ("vector_count", "metadata_count",
                        "vector_dimension", "num_shards", "plugins",
                        "raw_store"):
                assert st[key] == sj[key], key
        elif name == "plugin-info":
            assert json.loads(out_t) == json.loads(out_j)
        else:
            assert out_t == out_j, name
