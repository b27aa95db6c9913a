"""Plugin framework: ABC + manager.

Parity with the reference plugin system (reference wdbx/plugins/base.py):
``WDBXPlugin`` with abstract ``name``/``description``/``version``,
default no-op lifecycle, ``create_embedding`` raising by default, config
lookup convention ``WDBX_{PLUGIN}_{KEY}`` falling back to
``WDBX_{KEY}`` (reference wdbx/plugins/base.py:114-132), and a
``PluginManager`` that scans the package directory, instantiates the
first plugin subclass per module, and discovers external plugins via
entry points (reference wdbx/plugins/base.py:198-303). Broken modules
are logged and skipped, never fatal (reference wdbx/plugins/base.py:278-279).

Torch port of ``wdbx_tpu/plugins/base.py``. The builtin scan covers
``wdbx_tpu_torch.plugins`` and external plugins register under their own
entry-point group, ``wdbx_tpu_torch.plugins``: a plugin written against
``wdbx_tpu``'s ``WDBXPlugin`` would pull JAX into the port's process.
"""

from __future__ import annotations

import abc
import importlib
import logging
import pkgutil
import weakref
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from wdbx_tpu_torch.core.wdbx import WDBX

logger = logging.getLogger("wdbx_tpu_torch.plugins")


def facade_ref(wdbx: "WDBX") -> "WDBX":
    """A weak proxy to ``wdbx``. The facade owns its plugin manager and,
    through it, its plugins: a strong reference back would make a cycle
    that only the cyclic collector frees, and never once the store has
    frozen the heap (``wdbx_tpu_torch/utils/heap.py``). With the proxy a
    dropped facade is freed by its reference count; a plugin used after
    its facade is gone raises ``ReferenceError``."""
    if isinstance(wdbx, weakref.ProxyTypes):
        return wdbx
    return weakref.proxy(wdbx)


class PluginError(Exception):
    """Raised by plugins for operational failures."""


class WDBXPlugin(abc.ABC):

    #: True for plugins whose create_embedding produces embeddings
    #: itself (vs. consumers that DELEGATE to other plugins — those must
    #: not appear in the fallback chain or two consumers recurse into
    #: each other)
    embedding_provider = False
    """Base class for WDBX plugins."""

    def __init__(self, wdbx: "WDBX"):
        self.wdbx = facade_ref(wdbx)
        self.config = wdbx.config

    @property
    @abc.abstractmethod
    def name(self) -> str: ...

    @property
    @abc.abstractmethod
    def description(self) -> str: ...

    @property
    @abc.abstractmethod
    def version(self) -> str: ...

    async def initialize(self) -> bool:
        return True

    async def shutdown(self) -> bool:
        return True

    async def create_embedding(self, text: str) -> list[float]:
        raise PluginError(f"plugin {self.name} does not support embeddings")

    async def create_embeddings_batch(self, texts: list[str]) -> list[list[float]]:
        return [await self.create_embedding(t) for t in texts]

    def get_config(self, key: str, default: Any = None) -> Any:
        """Config lookup: ``{PLUGIN}_{KEY}`` then bare ``{KEY}``."""
        namespaced = f"{self.name.upper()}_{key.upper()}"
        value = self.config.get(namespaced)
        if value is not None:
            return value
        value = self.config.get(key.upper())
        return default if value is None else value

    def register_commands(self, cli: Any) -> None:
        """CLI integration hook; default registers nothing."""

    def get_stats(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "version": self.version,
            "description": self.description,
        }

    def get_help(self) -> str:
        return f"{self.name} v{self.version}: {self.description}"


class PluginManager:
    """Discovers, instantiates and tracks plugins."""

    def __init__(self, wdbx: "WDBX"):
        self.wdbx = facade_ref(wdbx)
        self.plugins: dict[str, WDBXPlugin] = {}

    def register(self, plugin: WDBXPlugin) -> None:
        self.plugins[plugin.name] = plugin

    def get(self, name: str) -> WDBXPlugin | None:
        return self.plugins.get(name)

    def load_builtin(self) -> None:
        """Scan wdbx_tpu_torch/plugins/*.py; first WDBXPlugin subclass per
        module wins; import errors are logged and skipped."""
        import wdbx_tpu_torch.plugins as pkg

        for info in pkgutil.iter_modules(pkg.__path__):
            if info.name in ("base", "__init__") or info.name.startswith("_"):
                continue
            try:
                module = importlib.import_module(
                    f"wdbx_tpu_torch.plugins.{info.name}"
                )
                for attr in vars(module).values():
                    if (
                        isinstance(attr, type)
                        and issubclass(attr, WDBXPlugin)
                        and attr is not WDBXPlugin
                    ):
                        self.register(attr(self.wdbx))
                        break
            except Exception as e:  # plugin faults must not kill startup
                logger.warning("failed to load plugin %s: %s", info.name, e)

    def load_entry_points(self) -> None:
        """External plugins via the ``wdbx_tpu_torch.plugins`` entry-point
        group."""
        try:
            from importlib.metadata import entry_points

            for ep in entry_points(group="wdbx_tpu_torch.plugins"):
                try:
                    cls = ep.load()
                    if issubclass(cls, WDBXPlugin):
                        self.register(cls(self.wdbx))
                except Exception as e:
                    logger.warning("failed to load entry point %s: %s", ep.name, e)
        except Exception as e:
            logger.debug("entry-point scan failed: %s", e)

    async def initialize_all(self) -> None:
        import asyncio

        async def _init(p: WDBXPlugin) -> None:
            try:
                await p.initialize()
            except Exception as e:
                logger.warning("plugin %s failed to initialize: %s", p.name, e)

        await asyncio.gather(*(_init(p) for p in self.plugins.values()))

    async def shutdown_all(self) -> None:
        import asyncio

        async def _stop(p: WDBXPlugin) -> None:
            try:
                await p.shutdown()
            except Exception as e:
                logger.warning("plugin %s failed to shut down: %s", p.name, e)

        await asyncio.gather(*(_stop(p) for p in self.plugins.values()))


def load_plugins(wdbx: "WDBX") -> PluginManager:
    manager = PluginManager(wdbx)
    manager.load_builtin()
    manager.load_entry_points()
    return manager


def demo_embedding(text: str, dim: int) -> list[float]:
    """Deterministic unit-norm pseudo-embedding from a text digest —
    the shared offline/demo-mode provider (stable across processes;
    zero-vector guard for empty digests)."""
    import hashlib

    import numpy as np

    seed = int.from_bytes(
        hashlib.blake2b(text.encode(), digest_size=8).digest(), "big"
    )
    rng = np.random.default_rng(seed)
    vec = rng.standard_normal(dim).astype(np.float32)
    vec /= np.linalg.norm(vec) or 1.0
    return vec.tolist()
