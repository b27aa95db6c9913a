"""LM Studio plugin: OpenAI-compatible local server client.

Behavioral parity with the reference LM Studio plugin (reference
wdbx/plugins/lmstudio.py): base URL ``http://{host}:{port}/v1``
(reference wdbx/plugins/lmstudio.py:58), ``/models`` listing with
first-model auto-select (:154-186), ``/embeddings`` single + true batch
(:188-282), ``/completions`` and ``/chat/completions`` with
non-streaming and SSE-streaming (``data:`` prefix, ``[DONE]`` sentinel)
variants (:284-574), bearer-token support (:115-129), three CLI
commands (:576-609). Plus an offline demo mode.

Torch port: ``wdbx_tpu/plugins/lmstudio.py`` with its imports repointed to
``wdbx_tpu_torch``; the behaviour is unchanged.
"""

from __future__ import annotations

import hashlib
import json
import logging
from typing import Any, AsyncGenerator

import numpy as np

from wdbx_tpu_torch.plugins.base import PluginError, WDBXPlugin

logger = logging.getLogger("wdbx_tpu_torch.plugins.lmstudio")


class LMStudioPlugin(WDBXPlugin):
    embedding_provider = True
    @property
    def name(self) -> str:
        return "lmstudio"

    @property
    def description(self) -> str:
        return "OpenAI-compatible client for a local LM Studio server"

    @property
    def version(self) -> str:
        return "0.1.0"

    def __init__(self, wdbx):
        super().__init__(wdbx)
        host = self.get_config("HOST", "localhost")
        port = self.get_config("PORT", 1234)
        self.base_url = f"http://{host}:{port}/v1"
        self.api_key = self.get_config("API_KEY", None)
        self.timeout = float(self.get_config("TIMEOUT", 60))
        self.default_model = self.get_config("DEFAULT_MODEL", None)
        self.demo = bool(self.get_config("DEMO", False))
        self._session = None
        self._stats = {"embeddings": 0, "completions": 0, "errors": 0}

    def _headers(self) -> dict[str, str]:
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        return headers

    async def initialize(self) -> bool:
        if self.demo:
            self.default_model = self.default_model or "demo-model"
            return True
        try:
            import aiohttp

            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout)
            )
            models = await self.list_models()
            if models and not self.default_model:
                # auto-select the first served model (reference behavior)
                self.default_model = models[0]
        except Exception as e:
            logger.warning("lmstudio not reachable (%s); calls will error", e)
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
    async def list_models(self) -> list[str]:
        if self.demo:
            return ["demo-model"]
        session = self._require_session()
        async with session.get(
            f"{self.base_url}/models", headers=self._headers()
        ) as resp:
            if resp.status != 200:
                raise PluginError(f"lmstudio /models returned {resp.status}")
            data = await resp.json()
            return [m["id"] for m in data.get("data", [])]

    async def create_embedding(self, text: str) -> list[float]:
        result = await self.create_embeddings_batch([text])
        return result[0]

    async def create_embeddings_batch(self, texts: list[str]) -> list[list[float]]:
        if self.demo:
            from wdbx_tpu_torch.plugins.base import demo_embedding

            self._stats["embeddings"] += len(texts)
            return [demo_embedding(t, self.wdbx.vector_dim) for t in texts]
        session = self._require_session()
        try:
            async with session.post(
                f"{self.base_url}/embeddings",
                headers=self._headers(),
                json={"input": texts, "model": self.default_model},
            ) as resp:
                if resp.status != 200:
                    raise PluginError(
                        f"lmstudio /embeddings returned {resp.status}"
                    )
                data = await resp.json()
                self._stats["embeddings"] += len(texts)
                rows = sorted(data["data"], key=lambda d: d.get("index", 0))
                return [row["embedding"] for row in rows]
        except PluginError:
            self._stats["errors"] += 1
            raise
        except Exception as e:
            self._stats["errors"] += 1
            raise PluginError(f"lmstudio embeddings failed: {e}") from e

    async def generate_text(
        self, prompt: str, model: str | None = None, **params: Any
    ) -> str:
        if self.demo:
            self._stats["completions"] += 1
            return f"[demo:{model or self.default_model}] {prompt[:64]}"
        session = self._require_session()
        async with session.post(
            f"{self.base_url}/completions",
            headers=self._headers(),
            json={
                "model": model or self.default_model,
                "prompt": prompt,
                "stream": False,
                **params,
            },
        ) as resp:
            if resp.status != 200:
                self._stats["errors"] += 1
                raise PluginError(f"lmstudio /completions returned {resp.status}")
            data = await resp.json()
            self._stats["completions"] += 1
            return data["choices"][0].get("text", "")

    async def chat(
        self, messages: list[dict[str, str]], model: str | None = None,
        **params: Any,
    ) -> str:
        if self.demo:
            self._stats["completions"] += 1
            last = messages[-1]["content"] if messages else ""
            return f"[demo-chat] {last[:64]}"
        session = self._require_session()
        async with session.post(
            f"{self.base_url}/chat/completions",
            headers=self._headers(),
            json={
                "model": model or self.default_model,
                "messages": messages,
                "stream": False,
                **params,
            },
        ) as resp:
            if resp.status != 200:
                self._stats["errors"] += 1
                raise PluginError(
                    f"lmstudio /chat/completions returned {resp.status}"
                )
            data = await resp.json()
            self._stats["completions"] += 1
            return data["choices"][0]["message"]["content"]

    async def _stream_sse(self, url: str, payload: dict) -> AsyncGenerator[dict, None]:
        session = self._require_session()
        async with session.post(
            url, headers=self._headers(), json=payload
        ) as resp:
            if resp.status != 200:
                raise PluginError(f"lmstudio {url} returned {resp.status}")
            async for raw in resp.content:
                line = raw.decode().strip()
                if not line.startswith("data:"):
                    continue
                body = line[len("data:"):].strip()
                if body == "[DONE]":
                    break
                try:
                    yield json.loads(body)
                except json.JSONDecodeError:
                    continue

    async def generate_text_stream(
        self, prompt: str, model: str | None = None
    ) -> AsyncGenerator[str, None]:
        if self.demo:
            for word in f"[demo] {prompt[:32]}".split():
                yield word + " "
            return
        async for chunk in self._stream_sse(
            f"{self.base_url}/completions",
            {"model": model or self.default_model, "prompt": prompt,
             "stream": True},
        ):
            text = chunk["choices"][0].get("text", "")
            if text:
                yield text

    async def chat_stream(
        self, messages: list[dict[str, str]], model: str | None = None
    ) -> AsyncGenerator[str, None]:
        if self.demo:
            yield "[demo-chat-stream]"
            return
        async for chunk in self._stream_sse(
            f"{self.base_url}/chat/completions",
            {"model": model or self.default_model, "messages": messages,
             "stream": True},
        ):
            delta = chunk["choices"][0].get("delta", {})
            text = delta.get("content", "")
            if text:
                yield text

    # -- CLI ---------------------------------------------------------------
    def register_commands(self, cli) -> None:
        cli.register_command(
            "lmstudio-models", self._cli_models, "List LM Studio models"
        )
        cli.register_command(
            "lmstudio-generate", self._cli_generate, "Generate via LM Studio"
        )
        cli.register_command(
            "lmstudio-chat", self._cli_chat, "Chat via LM Studio"
        )

    async def _cli_models(self, args):
        for model in await self.list_models():
            print(f"  {model}")

    async def _cli_generate(self, args):
        if not args:
            print("usage: lmstudio-generate <prompt...>")
            return 1
        print(await self.generate_text(" ".join(args)))

    async def _cli_chat(self, args):
        if not args:
            print("usage: lmstudio-chat <message...>")
            return 1
        print(await self.chat([{"role": "user", "content": " ".join(args)}]))

    def get_stats(self) -> dict[str, Any]:
        stats = super().get_stats()
        stats.update(self._stats, base_url=self.base_url, demo=self.demo)
        return stats
