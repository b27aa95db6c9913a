"""Plugins (torch port of ``wdbx_tpu/plugins/``): the framework, the
embedding-provider order and the builtin plugins."""

from wdbx_tpu_torch.plugins.base import (
    PluginError,
    PluginManager,
    WDBXPlugin,
    load_plugins,
)

#: embedding-provider priority, same order as the reference's embedding
#: endpoints (reference wdbx/api/server.py:198-204), lmstudio appended
EMBEDDING_PLUGIN_PRIORITY = [
    "openai", "ollama", "huggingface", "sentencetransformers", "lmstudio",
]


def iter_embedding_plugins(manager):
    """Embedding PROVIDERS in fallback order: the priority names first,
    then remaining plugins that produce embeddings themselves
    (``embedding_provider = True``). Consumer plugins that merely
    delegate (webscraper, social_media) are excluded — two delegating
    consumers falling back to each other would recurse until the
    interpreter limit. Shared by the API embedding endpoints, the CLI's
    --from-text, and the consumer plugins."""
    if manager is None:
        return
    for name in EMBEDDING_PLUGIN_PRIORITY:
        plugin = manager.get(name)
        if plugin is not None:
            yield plugin
    for name, plugin in manager.plugins.items():
        if name not in EMBEDDING_PLUGIN_PRIORITY and getattr(
            plugin, "embedding_provider", False
        ):
            yield plugin


__all__ = [
    "WDBXPlugin", "PluginManager", "PluginError", "load_plugins",
    "EMBEDDING_PLUGIN_PRIORITY", "iter_embedding_plugins",
]
