"""Local embedding provider: transformer mean-pooling, no network.

Fills the "sentencetransformers" slot of the embedding fallback chain
(reference wdbx/plugins priority at wdbx/api/server.py:198-204; the
reference delegates to a local SentenceTransformer at
wdbx/plugins/webscraper.py:437-467 and social_media.py:1113-1161). Uses
plain ``transformers`` + CPU torch against a LOCAL
model directory — no downloads. With SENTENCETRANSFORMERS_DEMO=true it
serves deterministic hash-based demo embeddings instead, keeping the
chain testable offline (the demo-mode ethos of the social plugin).

Config: SENTENCETRANSFORMERS_MODEL_PATH (local dir with a tokenizer +
model), SENTENCETRANSFORMERS_DEMO=true to opt into hash-based demo
embeddings (OFF by default: silently serving random vectors would
corrupt ingested corpora — without a model or the demo flag the plugin
raises, letting the API fall through to 501),
SENTENCETRANSFORMERS_DIM (demo dimension, default = store dim).

Torch port: ``wdbx_tpu/plugins/local_embeddings.py`` with its imports repointed to
``wdbx_tpu_torch``; the behaviour is unchanged.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from typing import Any

import numpy as np

from wdbx_tpu_torch.plugins.base import PluginError, WDBXPlugin

logger = logging.getLogger("wdbx_tpu_torch.plugins.local_embeddings")


class LocalEmbeddingsPlugin(WDBXPlugin):
    embedding_provider = True
    @property
    def name(self) -> str:
        return "sentencetransformers"

    @property
    def description(self) -> str:
        return "Local transformer embeddings (mean pooling, offline)"

    @property
    def version(self) -> str:
        return "0.1.0"

    def __init__(self, wdbx):
        super().__init__(wdbx)
        self.model_path = self.get_config("MODEL_PATH", None)
        self.demo = bool(self.get_config("DEMO", False))
        self.dim = int(
            self.get_config("DIM", getattr(wdbx, "vector_dim", 384))
        )
        self._model = None
        self._tokenizer = None

    def _demo(self) -> bool:
        return self.demo and not self.model_path

    def _load_model(self):
        if self._model is not None:
            return
        try:
            import torch  # noqa: F401
            from transformers import AutoModel, AutoTokenizer
        except ImportError:
            raise PluginError(
                "transformers/torch are required for local embeddings "
                "(pip install transformers torch)"
            )
        try:
            self._tokenizer = AutoTokenizer.from_pretrained(
                self.model_path, local_files_only=True
            )
            self._model = AutoModel.from_pretrained(
                self.model_path, local_files_only=True
            )
            self._model.eval()
        except Exception as e:
            raise PluginError(
                f"failed to load local model at {self.model_path!r}: {e}"
            )

    def _embed_real(self, texts: list[str]) -> list[list[float]]:
        import torch

        self._load_model()
        enc = self._tokenizer(
            texts, padding=True, truncation=True, max_length=512,
            return_tensors="pt",
        )
        with torch.no_grad():
            out = self._model(**enc)
        hidden = out.last_hidden_state  # (B, T, H)
        mask = enc["attention_mask"].unsqueeze(-1).float()
        pooled = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
        pooled = torch.nn.functional.normalize(pooled, dim=-1)
        return [row.tolist() for row in pooled]

    def _embed_demo(self, text: str) -> list[float]:
        from wdbx_tpu_torch.plugins.base import demo_embedding

        return demo_embedding(text, self.dim)

    def _require_configured(self) -> None:
        if not self.model_path and not self.demo:
            raise PluginError(
                "no local model configured: set "
                "WDBX_SENTENCETRANSFORMERS_MODEL_PATH (or opt into demo "
                "embeddings with WDBX_SENTENCETRANSFORMERS_DEMO=true)"
            )

    async def create_embedding(self, text: str) -> list[float]:
        self._require_configured()
        if self._demo():
            return self._embed_demo(text)
        return (await asyncio.to_thread(self._embed_real, [text]))[0]

    async def create_embeddings_batch(
        self, texts: list[str]
    ) -> list[list[float]]:
        self._require_configured()
        if self._demo():
            return [self._embed_demo(t) for t in texts]
        return await asyncio.to_thread(self._embed_real, list(texts))

    def get_stats(self) -> dict[str, Any]:
        stats = super().get_stats()
        stats.update(
            demo=self._demo(),
            model_path=self.model_path,
            loaded=self._model is not None,
        )
        return stats
