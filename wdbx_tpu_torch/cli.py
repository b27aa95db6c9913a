"""Command-line interface.

Parity with the reference CLI (reference wdbx/cli.py): a command
registry (reference wdbx/cli.py:185-202), the 12 built-in commands
(reference wdbx/cli.py:51-172 — help, version, store, search, get,
delete, update-metadata, stats, clear, plugins, plugin-info, serve),
plugin-contributed commands, one-shot argparse mode and an interactive
REPL (reference wdbx/cli.py:228-329). ``--from-text`` resolves an
embedding plugin by the same priority chain as the API server
(reference wdbx/cli.py:410-427).

Torch port of ``wdbx_tpu/cli.py``, run as ``python -m wdbx_tpu_torch.cli``
or ``wdbx-tpu-torch``. One flag more than the JAX CLI: ``--device``, the
facade's ``device=`` (default: the CUDA device, raising without one;
``cpu`` on request). ``heal`` runs ``WDBX.heal`` and prints its report.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shlex
import sys
from typing import Any, Callable

from wdbx_tpu_torch.core.wdbx import WDBX

CommandHandler = Callable[["WDBXCLI", list[str]], "Any"]


class WDBXCLI:
    """Registry-driven CLI over the WDBX facade."""

    def __init__(self, wdbx: WDBX):
        self.wdbx = wdbx
        self.commands: dict[str, dict[str, Any]] = {}
        self.running = False
        self._register_builtins()
        self._register_plugin_commands()

    # -- registry ----------------------------------------------------------
    def register_command(
        self,
        name: str,
        handler: CommandHandler,
        description: str = "",
    ) -> None:
        self.commands[name] = {"handler": handler, "description": description}

    def _register_builtins(self) -> None:
        b = [
            ("help", self._cmd_help, "Show available commands"),
            ("version", self._cmd_version, "Show version"),
            ("store", self._cmd_store, "Store a vector"),
            ("search", self._cmd_search, "Search for similar vectors"),
            ("get", self._cmd_get, "Get a vector by ID"),
            ("delete", self._cmd_delete, "Delete a vector by ID"),
            ("update-metadata", self._cmd_update_metadata, "Update metadata"),
            ("stats", self._cmd_stats, "Show database statistics"),
            ("clear", self._cmd_clear, "Remove all vectors"),
            ("plugins", self._cmd_plugins, "List loaded plugins"),
            ("plugin-info", self._cmd_plugin_info, "Show plugin details"),
            ("serve", self._cmd_serve, "Start the REST API server"),
            ("import", self._cmd_import, "Bulk-load vectors from CSV/JSONL"),
            ("optimize", self._cmd_optimize, "Compact and retrain indexes"),
            ("tune", self._cmd_tune,
             "Tune ANN probe counts to a recall target"),
            ("heal", self._cmd_heal, "Detect failures and recover shards"),
            ("exit", self._cmd_exit, "Exit interactive mode"),
        ]
        for name, handler, desc in b:
            self.register_command(name, handler, desc)

    def _register_plugin_commands(self) -> None:
        manager = self.wdbx.plugin_manager
        if manager is None:
            return
        for plugin in manager.plugins.values():
            try:
                plugin.register_commands(self)
            except Exception as e:
                print(f"warning: plugin {plugin.name} command registration failed: {e}")

    # -- execution ---------------------------------------------------------
    async def run_command(self, name: str, args: list[str]) -> int:
        cmd = self.commands.get(name)
        if cmd is None:
            print(f"Unknown command: {name} (try 'help')")
            return 1
        try:
            result = cmd["handler"](args)
            if asyncio.iscoroutine(result):
                result = await result
        except Exception as e:
            # bad JSON, dimension mismatches, missing plugins, ... must
            # print and re-prompt, not kill the whole session
            print(f"{name}: {type(e).__name__}: {e}")
            return 1
        return 0 if result is None or result is True else int(result)

    async def repl(self) -> None:
        """Interactive mode (parity: reference wdbx/cli.py:228-260)."""
        self.running = True
        print("wdbx-tpu-torch interactive mode — 'help' for commands, "
              "'exit' to quit")
        while self.running:
            try:
                line = await asyncio.to_thread(input, "wdbx> ")
            except (EOFError, KeyboardInterrupt):
                break
            line = line.strip()
            if not line:
                continue
            try:
                parts = shlex.split(line)
            except ValueError as e:  # unbalanced quotes
                print(f"parse error: {e}")
                continue
            await self.run_command(parts[0], parts[1:])

    # -- embedding helper --------------------------------------------------
    async def _embed_text(self, text: str) -> list[float]:
        from wdbx_tpu_torch.plugins import iter_embedding_plugins

        for plugin in iter_embedding_plugins(self.wdbx.plugin_manager):
            try:
                return list(await plugin.create_embedding(text))
            except Exception:
                continue
        raise RuntimeError("no embedding plugin available for --from-text")

    # -- built-in commands -------------------------------------------------
    def _cmd_help(self, args: list[str]) -> None:
        print("Available commands:")
        for name in sorted(self.commands):
            print(f"  {name:18} {self.commands[name]['description']}")

    def _cmd_version(self, args: list[str]) -> None:
        from wdbx_tpu_torch import __version__

        print(f"wdbx-tpu-torch {__version__}")

    async def _cmd_store(self, args: list[str]) -> int:
        p = argparse.ArgumentParser(prog="store", exit_on_error=False)
        p.add_argument("--vector", help="JSON array of floats")
        p.add_argument("--from-text", help="embed this text via a plugin")
        p.add_argument("--metadata", help="JSON object")
        p.add_argument("--id", help="custom vector id")
        try:
            ns = p.parse_args(args)
        except (argparse.ArgumentError, SystemExit):
            return 1
        if ns.vector:
            vector = json.loads(ns.vector)
        elif ns.from_text:
            vector = await self._embed_text(ns.from_text)
        else:
            print("store: provide --vector or --from-text")
            return 1
        metadata = json.loads(ns.metadata) if ns.metadata else None
        vid = await self.wdbx.vector_store_async(vector, metadata, ns.id)
        print(f"stored: {vid}")
        return 0

    async def _cmd_search(self, args: list[str]) -> int:
        p = argparse.ArgumentParser(prog="search", exit_on_error=False)
        p.add_argument("--vector", help="JSON array of floats")
        p.add_argument("--from-text", help="embed this text via a plugin")
        p.add_argument("--limit", type=int, default=10)
        p.add_argument("--threshold", type=float, default=0.0)
        p.add_argument("--filter", help="JSON metadata filter")
        try:
            ns = p.parse_args(args)
        except (argparse.ArgumentError, SystemExit):
            return 1
        if ns.vector:
            query = json.loads(ns.vector)
        elif ns.from_text:
            query = await self._embed_text(ns.from_text)
        else:
            print("search: provide --vector or --from-text")
            return 1
        flt = json.loads(ns.filter) if ns.filter else None
        hits = await self.wdbx.vector_search_async(
            query, ns.limit, ns.threshold, flt
        )
        if not hits:
            print("no results")
            return 0
        for vid, score, meta in hits:
            print(f"{vid}  score={score:.4f}  metadata={json.dumps(meta)}")
        return 0

    async def _cmd_get(self, args: list[str]) -> int:
        if not args:
            print("usage: get <vector_id>")
            return 1
        result = await self.wdbx.get_vector_async(args[0])
        if result is None:
            print(f"not found: {args[0]}")
            return 1
        vector, metadata = result
        print(json.dumps({"vector_id": args[0], "vector": vector,
                          "metadata": metadata}))
        return 0

    async def _cmd_delete(self, args: list[str]) -> int:
        if not args:
            print("usage: delete <vector_id>")
            return 1
        if await self.wdbx.delete_vector_async(args[0]):
            print(f"deleted: {args[0]}")
            return 0
        print(f"not found: {args[0]}")
        return 1

    async def _cmd_update_metadata(self, args: list[str]) -> int:
        p = argparse.ArgumentParser(prog="update-metadata", exit_on_error=False)
        p.add_argument("id")
        p.add_argument("--metadata", required=True, help="JSON object")
        try:
            ns = p.parse_args(args)
        except (argparse.ArgumentError, SystemExit):
            return 1
        if await self.wdbx.update_metadata_async(ns.id, json.loads(ns.metadata)):
            print(f"updated: {ns.id}")
            return 0
        print(f"not found: {ns.id}")
        return 1

    def _cmd_stats(self, args: list[str]) -> None:
        print(json.dumps(self.wdbx.get_stats(), indent=2, default=str))

    async def _cmd_clear(self, args: list[str]) -> None:
        count = await self.wdbx.clear_async()
        print(f"removed {count} vectors")

    def _cmd_plugins(self, args: list[str]) -> None:
        manager = self.wdbx.plugin_manager
        plugins = manager.plugins.values() if manager else []
        if not plugins:
            print("no plugins loaded")
            return
        for plugin in plugins:
            print(f"  {plugin.name:16} v{plugin.version:8} {plugin.description}")

    def _cmd_plugin_info(self, args: list[str]) -> int:
        if not args:
            print("usage: plugin-info <name>")
            return 1
        plugin = self.wdbx.get_plugin(args[0])
        if plugin is None:
            print(f"plugin not found: {args[0]}")
            return 1
        print(json.dumps(plugin.get_stats(), indent=2, default=str))
        return 0

    async def _cmd_serve(self, args: list[str]) -> int:
        p = argparse.ArgumentParser(prog="serve", exit_on_error=False)
        p.add_argument("--host", default=None)
        p.add_argument("--port", type=int, default=None)
        p.add_argument(
            "--warm", action="store_true",
            help="serve one batch before accepting requests (the "
                 "kernels' build at first use and the device set-up "
                 "otherwise land on live traffic)",
        )
        try:
            ns = p.parse_args(args)
        except (argparse.ArgumentError, SystemExit):
            return 1
        from wdbx_tpu_torch.api.server import WDBXAPIServer

        server = WDBXAPIServer(self.wdbx, host=ns.host, port=ns.port)
        await server.initialize()
        if ns.warm:
            # server.warmup reads the QueryBatcher's real coalesce
            # limit (API_BATCH_MAX), not a hardcoded width
            widths = await server.warmup()
            print(f"warmed {widths} batch width(s)")
        print(f"serving on http://{server.host}:{server.port}/api/v1 (ctrl-c to stop)")
        try:
            await server.serve_forever()
        except (KeyboardInterrupt, asyncio.CancelledError):
            await server.stop()
        return 0

    async def _cmd_import(self, args: list[str]) -> int:
        p = argparse.ArgumentParser(prog="import", exit_on_error=False)
        p.add_argument("path", help="CSV or JSONL file")
        p.add_argument("--id-field", default="id")
        p.add_argument("--vector-field", default="vector")
        p.add_argument("--batch-size", type=int, default=4096)
        try:
            ns = p.parse_args(args)
        except (argparse.ArgumentError, SystemExit):
            return 1
        from wdbx_tpu_torch.utils.data_utils import (
            load_vectors_from_csv,
            load_vectors_from_jsonl,
        )

        if ns.path.endswith((".jsonl", ".ndjson")):
            vectors, metadata = load_vectors_from_jsonl(
                ns.path, id_field=ns.id_field, vector_field=ns.vector_field
            )
        else:
            vectors, metadata = load_vectors_from_csv(
                ns.path, id_column=ns.id_field, vector_column=ns.vector_field
            )
        ids = list(vectors)
        total = 0
        for i in range(0, len(ids), ns.batch_size):
            chunk = ids[i : i + ns.batch_size]
            total += await self.wdbx.batch_store_async(
                {vid: vectors[vid] for vid in chunk},
                {vid: metadata.get(vid, {}) for vid in chunk},
            )
        print(f"imported {total} vectors from {ns.path}")
        return 0

    async def _cmd_tune(self, args: list[str]) -> int:
        ap = argparse.ArgumentParser(prog="tune", exit_on_error=False)
        ap.add_argument("--target-recall", type=float, default=0.95)
        try:
            ns = ap.parse_args(args)
        except (argparse.ArgumentError, SystemExit):
            return 1
        report = await self.wdbx.tune_async(ns.target_recall)
        print(json.dumps(report, indent=2, default=str))
        return 0

    async def _cmd_optimize(self, args: list[str]) -> None:
        # --background: serve-through COW rebuild for clustered indexes
        # (needs 2x-slab HBM headroom); scoped to this call — the
        # configured IVF_BACKGROUND_REBUILD is untouched
        bg = True if "--background" in args else None
        await self.wdbx.optimize_async(background=bg)
        print("optimized")

    async def _cmd_heal(self, args: list[str]) -> None:
        import asyncio
        import json as _json

        ap = argparse.ArgumentParser(prog="heal")
        ap.add_argument(
            "--remesh", action="store_true",
            help="escalate to live re-meshing: re-stripe sharded indexes "
                 "onto the surviving devices if some stay dead",
        )
        try:
            ns = ap.parse_args(args)
        except (argparse.ArgumentError, SystemExit):
            return 1
        report = await asyncio.to_thread(
            self.wdbx.heal, True if ns.remesh else None
        )
        print(_json.dumps(report, indent=2, default=str))

    def _cmd_exit(self, args: list[str]) -> None:
        self.running = False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="wdbx-tpu-torch",
        description="vector database CLI (PyTorch / CUDA)",
    )
    # Defaults are None so omitted flags defer to WDBX_* env vars /
    # config files instead of silently overriding them.
    p.add_argument("--data-dir", default=None)
    p.add_argument("--dimension", type=int, default=None)
    p.add_argument("--shards", type=int, default=None)
    p.add_argument("--no-plugins", action="store_true")
    p.add_argument("--log-level", default="INFO")
    p.add_argument(
        "--device", default=None,
        help="torch device of the indexes (default: the CUDA device; "
             "'cpu' to run on the CPU)",
    )
    p.add_argument("command", nargs="?", help="command to run (omit for REPL)")
    p.add_argument("args", nargs=argparse.REMAINDER)
    return p


async def amain(argv: list[str] | None = None) -> int:
    ns = build_parser().parse_args(argv)
    wdbx = WDBX(
        vector_dimension=ns.dimension,
        num_shards=ns.shards,
        data_dir=ns.data_dir,
        enable_plugins=not ns.no_plugins,
        device=ns.device,
        log_level=ns.log_level,
    )
    await wdbx.initialize()
    cli = WDBXCLI(wdbx)
    try:
        if ns.command:
            return await cli.run_command(ns.command, ns.args)
        await cli.repl()
        return 0
    finally:
        await wdbx.shutdown()


def main() -> None:
    sys.exit(asyncio.run(amain()))


if __name__ == "__main__":
    main()
