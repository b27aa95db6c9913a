"""Ollama plugin: embeddings + generation via the local Ollama HTTP API.

Clean-room implementation of the behavior the reference *intends*
(reference wdbx/plugins/ollama.py — whose shipped file is syntactically
broken at module scope, lines 13-50, and missing its aiohttp imports):
``/api/tags`` connection check + model list, ``/api/pull`` with streamed
progress, ``/api/embeddings``, batch embeddings via per-text gather,
``/api/generate`` in non-streaming and line-streamed variants,
``[INST]``-style chat funneled into generate, ``/api/show`` model info,
and four CLI commands. Defaults match the reference
(wdbx/plugins/ollama.py:81-85).

Adds a **demo mode** (``OLLAMA_DEMO=true``): deterministic local
embeddings/generations with no server — the testing ethos the reference
only has in its social plugin (reference wdbx/plugins/social_media.py:48).

Torch port: ``wdbx_tpu/plugins/ollama.py`` with its imports repointed to
``wdbx_tpu_torch``; the behaviour is unchanged.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
from typing import Any, AsyncGenerator

import numpy as np

from wdbx_tpu_torch.plugins.base import PluginError, WDBXPlugin
from wdbx_tpu_torch.plugins.base import demo_embedding as _demo_embedding

logger = logging.getLogger("wdbx_tpu_torch.plugins.ollama")


class OllamaPlugin(WDBXPlugin):
    embedding_provider = True
    @property
    def name(self) -> str:
        return "ollama"

    @property
    def description(self) -> str:
        return "Embeddings and text generation via a local Ollama server"

    @property
    def version(self) -> str:
        return "0.1.0"

    def __init__(self, wdbx):
        super().__init__(wdbx)
        self.host = str(self.get_config("HOST", "http://localhost:11434")).rstrip("/")
        self.model = self.get_config("MODEL", "llama2")
        self.embedding_model = self.get_config(
            "EMBEDDING_MODEL", "all-MiniLM-L6-v2"
        )
        self.timeout = float(self.get_config("TIMEOUT", 30))
        self.demo = bool(self.get_config("DEMO", False))
        self._session = None
        self._stats = {"embeddings": 0, "generations": 0, "errors": 0}

    # -- lifecycle ---------------------------------------------------------
    async def initialize(self) -> bool:
        if self.demo:
            return True
        try:
            import aiohttp

            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout)
            )
            await self.check_connection()
        except Exception as e:
            logger.warning("ollama not reachable (%s); calls will error", e)
        return True

    async def shutdown(self) -> bool:
        if self._session is not None:
            await self._session.close()
            self._session = None
        return True

    def _require_session(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout)
            )
        return self._session

    # -- API surface -------------------------------------------------------
    async def check_connection(self) -> bool:
        if self.demo:
            return True
        session = self._require_session()
        async with session.get(f"{self.host}/api/tags") as resp:
            return resp.status == 200

    async def list_models(self) -> list[str]:
        if self.demo:
            return [self.model, self.embedding_model]
        session = self._require_session()
        async with session.get(f"{self.host}/api/tags") as resp:
            if resp.status != 200:
                raise PluginError(f"ollama /api/tags returned {resp.status}")
            data = await resp.json()
            return [m["name"] for m in data.get("models", [])]

    async def pull_model(self, model: str) -> bool:
        """Streamed /api/pull; logs progress lines."""
        if self.demo:
            return True
        session = self._require_session()
        async with session.post(
            f"{self.host}/api/pull", json={"name": model}
        ) as resp:
            if resp.status != 200:
                raise PluginError(f"ollama /api/pull returned {resp.status}")
            async for raw in resp.content:
                if not raw.strip():
                    continue
                try:
                    status = json.loads(raw)
                    if "status" in status:
                        logger.info("pull %s: %s", model, status["status"])
                except json.JSONDecodeError:
                    continue
        return True

    async def create_embedding(self, text: str) -> list[float]:
        if self.demo:
            self._stats["embeddings"] += 1
            return _demo_embedding(text, self.wdbx.vector_dim)
        session = self._require_session()
        try:
            async with session.post(
                f"{self.host}/api/embeddings",
                json={"model": self.embedding_model, "prompt": text},
            ) as resp:
                if resp.status != 200:
                    raise PluginError(
                        f"ollama embeddings returned {resp.status}"
                    )
                data = await resp.json()
                self._stats["embeddings"] += 1
                return data["embedding"]
        except PluginError:
            self._stats["errors"] += 1
            raise
        except Exception as e:
            self._stats["errors"] += 1
            raise PluginError(f"ollama embedding failed: {e}") from e

    async def create_embeddings_batch(self, texts: list[str]) -> list[list[float]]:
        return list(
            await asyncio.gather(*(self.create_embedding(t) for t in texts))
        )

    async def generate_text(
        self, prompt: str, model: str | None = None, **options: Any
    ) -> str:
        if self.demo:
            self._stats["generations"] += 1
            return f"[demo:{model or self.model}] {prompt[:64]}"
        session = self._require_session()
        async with session.post(
            f"{self.host}/api/generate",
            json={
                "model": model or self.model,
                "prompt": prompt,
                "stream": False,
                **({"options": options} if options else {}),
            },
        ) as resp:
            if resp.status != 200:
                self._stats["errors"] += 1
                raise PluginError(f"ollama generate returned {resp.status}")
            data = await resp.json()
            self._stats["generations"] += 1
            return data.get("response", "")

    async def generate_text_stream(
        self, prompt: str, model: str | None = None
    ) -> AsyncGenerator[str, None]:
        if self.demo:
            for word in f"[demo] {prompt[:32]}".split():
                yield word + " "
            return
        session = self._require_session()
        async with session.post(
            f"{self.host}/api/generate",
            json={"model": model or self.model, "prompt": prompt, "stream": True},
        ) as resp:
            if resp.status != 200:
                raise PluginError(f"ollama generate returned {resp.status}")
            async for raw in resp.content:
                if not raw.strip():
                    continue
                try:
                    chunk = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                if chunk.get("done"):
                    break
                yield chunk.get("response", "")

    async def chat(self, messages: list[dict[str, str]], **options: Any) -> str:
        """[INST]-formatted concatenation funneled into generate (the
        reference's chat scheme, wdbx/plugins/ollama.py:448-512)."""
        parts = []
        for msg in messages:
            role, content = msg.get("role", "user"), msg.get("content", "")
            if role == "system":
                parts.append(f"[INST] <<SYS>> {content} <</SYS>> [/INST]")
            elif role == "user":
                parts.append(f"[INST] {content} [/INST]")
            else:
                parts.append(content)
        return await self.generate_text("\n".join(parts), **options)

    async def model_info(self, model: str | None = None) -> dict[str, Any]:
        if self.demo:
            return {"name": model or self.model, "demo": True}
        session = self._require_session()
        async with session.post(
            f"{self.host}/api/show", json={"name": model or self.model}
        ) as resp:
            if resp.status != 200:
                raise PluginError(f"ollama /api/show returned {resp.status}")
            return await resp.json()

    # -- CLI ---------------------------------------------------------------
    def register_commands(self, cli) -> None:
        cli.register_command(
            "ollama-models", self._cli_models, "List Ollama models"
        )
        cli.register_command(
            "ollama-generate", self._cli_generate, "Generate text via Ollama"
        )
        cli.register_command(
            "ollama-embed", self._cli_embed, "Create an embedding via Ollama"
        )
        cli.register_command(
            "ollama-pull", self._cli_pull, "Pull an Ollama model"
        )

    async def _cli_models(self, args):
        for model in await self.list_models():
            print(f"  {model}")

    async def _cli_generate(self, args):
        if not args:
            print("usage: ollama-generate <prompt...>")
            return 1
        print(await self.generate_text(" ".join(args)))

    async def _cli_embed(self, args):
        if not args:
            print("usage: ollama-embed <text...>")
            return 1
        emb = await self.create_embedding(" ".join(args))
        print(json.dumps(emb[:8]) + f" ... ({len(emb)} dims)")

    async def _cli_pull(self, args):
        if not args:
            print("usage: ollama-pull <model>")
            return 1
        await self.pull_model(args[0])
        print(f"pulled {args[0]}")

    def get_stats(self) -> dict[str, Any]:
        stats = super().get_stats()
        stats.update(self._stats, host=self.host, demo=self.demo)
        return stats
