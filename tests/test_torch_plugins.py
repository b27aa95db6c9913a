"""The port's plugins (wdbx_tpu_torch.plugins) on the CPU.

The cases of ``tests/test_plugins.py`` run on the port — discovery,
lifecycle, demo modes, and mocked-HTTP clients — with every facade built
with ``device="cpu"``; then the facade's plugin cases of
``test_facade.py`` / ``test_store.py``, and parity with the JAX package:
``demo_embedding`` gives bit-identical vectors in both packages. No case
of ``test_plugins.py`` is left out."""

from unittest import mock

import numpy as np
import pytest

from wdbx_tpu_torch import WDBX as _WDBX
from wdbx_tpu_torch.plugins import PluginError, PluginManager, WDBXPlugin
from wdbx_tpu_torch.plugins.lmstudio import LMStudioPlugin
from wdbx_tpu_torch.plugins.ollama import OllamaPlugin
from wdbx_tpu_torch.plugins.social_media import SocialMediaPlugin
from wdbx_tpu_torch.plugins.webscraper import WebScraperPlugin


def WDBX(**kw):
    """The port's facade on the CPU."""
    return _WDBX(device="cpu", **kw)


@pytest.fixture
def db(temp_dir):
    return WDBX(vector_dimension=8, data_dir=temp_dir, enable_plugins=False)


def _fake_response(payload, status=200):
    resp = mock.MagicMock()
    resp.status = status

    async def _json():
        return payload

    resp.json = _json
    ctx = mock.MagicMock()
    ctx.__aenter__ = mock.AsyncMock(return_value=resp)
    ctx.__aexit__ = mock.AsyncMock(return_value=False)
    return ctx


class TestPluginFramework:
    def test_builtin_discovery(self, temp_dir):
        db = WDBX(vector_dimension=8, data_dir=temp_dir, enable_plugins=True)
        names = set(db.plugin_manager.plugins)
        assert {"ollama", "lmstudio", "webscraper", "social_media"} <= names

    def test_adhoc_registration(self, db):
        class MyPlugin(WDBXPlugin):
            name = "mine"
            description = "d"
            version = "1"

        db.register_plugin(MyPlugin(db))
        assert db.get_plugin("mine").name == "mine"

    async def test_lifecycle_isolation(self, db):
        class Bad(WDBXPlugin):
            name = "bad"
            description = "d"
            version = "1"

            async def initialize(self):
                raise RuntimeError("boom")

        manager = PluginManager(db)
        manager.register(Bad(db))
        await manager.initialize_all()  # must not raise
        await manager.shutdown_all()

    async def test_default_embedding_raises(self, db):
        class Plain(WDBXPlugin):
            name = "plain"
            description = "d"
            version = "1"

        with pytest.raises(PluginError):
            await Plain(db).create_embedding("x")

    def test_config_namespacing(self, db):
        db.config.set("OLLAMA_TIMEOUT", 99)
        plugin = OllamaPlugin(db)
        assert plugin.timeout == 99.0
        db.config.set("SHARED_KEY", "fallback")

        class P(WDBXPlugin):
            name = "p"
            description = "d"
            version = "1"

        assert P(db).get_config("SHARED_KEY") == "fallback"


class TestOllama:
    async def test_demo_embedding_deterministic(self, db):
        db.config.set("OLLAMA_DEMO", True)
        plugin = OllamaPlugin(db)
        e1 = await plugin.create_embedding("hello")
        e2 = await plugin.create_embedding("hello")
        e3 = await plugin.create_embedding("world")
        assert e1 == e2 and e1 != e3 and len(e1) == 8
        np.testing.assert_allclose(np.linalg.norm(e1), 1.0, rtol=1e-5)

    async def test_demo_generate_and_chat(self, db):
        db.config.set("OLLAMA_DEMO", True)
        plugin = OllamaPlugin(db)
        out = await plugin.generate_text("tell me")
        assert "tell me" in out
        out = await plugin.chat([{"role": "user", "content": "hi"}])
        assert "[INST]" in out or "hi" in out

    async def test_mocked_embeddings_endpoint(self, db):
        plugin = OllamaPlugin(db)
        session = mock.MagicMock()
        session.post = mock.MagicMock(
            return_value=_fake_response({"embedding": [0.1] * 8})
        )
        plugin._session = session
        emb = await plugin.create_embedding("text")
        assert emb == [0.1] * 8
        url = session.post.call_args[0][0]
        assert url.endswith("/api/embeddings")

    async def test_mocked_models_list(self, db):
        plugin = OllamaPlugin(db)
        session = mock.MagicMock()
        session.get = mock.MagicMock(
            return_value=_fake_response({"models": [{"name": "llama2"}]})
        )
        plugin._session = session
        assert await plugin.list_models() == ["llama2"]

    async def test_http_error_raises_plugin_error(self, db):
        plugin = OllamaPlugin(db)
        session = mock.MagicMock()
        session.post = mock.MagicMock(return_value=_fake_response({}, status=500))
        plugin._session = session
        with pytest.raises(PluginError):
            await plugin.create_embedding("x")


class TestLMStudio:
    async def test_demo_mode(self, db):
        db.config.set("LMSTUDIO_DEMO", True)
        plugin = LMStudioPlugin(db)
        await plugin.initialize()
        embs = await plugin.create_embeddings_batch(["a", "b"])
        assert len(embs) == 2 and len(embs[0]) == 8
        out = await plugin.chat([{"role": "user", "content": "yo"}])
        assert "yo" in out

    async def test_mocked_batch_embeddings(self, db):
        plugin = LMStudioPlugin(db)
        session = mock.MagicMock()
        session.post = mock.MagicMock(
            return_value=_fake_response(
                {
                    "data": [
                        {"index": 1, "embedding": [2.0] * 4},
                        {"index": 0, "embedding": [1.0] * 4},
                    ]
                }
            )
        )
        plugin._session = session
        embs = await plugin.create_embeddings_batch(["a", "b"])
        # order restored by index
        assert embs == [[1.0] * 4, [2.0] * 4]

    async def test_mocked_chat_routes_by_url(self, db):
        plugin = LMStudioPlugin(db)

        def route(url, **kw):
            if url.endswith("/chat/completions"):
                return _fake_response(
                    {"choices": [{"message": {"content": "chat-reply"}}]}
                )
            return _fake_response({"choices": [{"text": "completion-reply"}]})

        session = mock.MagicMock()
        session.post = mock.MagicMock(side_effect=route)
        plugin._session = session
        assert await plugin.chat([{"role": "user", "content": "x"}]) == "chat-reply"
        assert await plugin.generate_text("x") == "completion-reply"


class TestWebScraper:
    def test_extract_content_prefers_main(self, db):
        plugin = WebScraperPlugin(db)
        html = """
        <html><head><title>T</title><script>junk()</script></head>
        <body><nav>menu</nav><main><p>real content here</p></main>
        <footer>foot</footer></body></html>
        """
        out = plugin.extract_content(html)
        assert out["title"] == "T"
        assert "real content here" in out["content"]
        assert "menu" not in out["content"]
        assert "junk" not in out["content"]

    def test_extract_links_same_domain_only(self, db):
        plugin = WebScraperPlugin(db)
        html = (
            '<a href="/page2">a</a>'
            '<a href="https://example.com/page3">b</a>'
            '<a href="https://other.org/x">c</a>'
        )
        links = plugin.extract_links(html, "https://example.com/page1")
        assert links == [
            "https://example.com/page2",
            "https://example.com/page3",
        ]

    async def test_store_webpage_pipeline(self, db):
        db.config.set("OLLAMA_DEMO", True)
        db.register_plugin(OllamaPlugin(db))
        scraper = WebScraperPlugin(db)
        db.register_plugin(scraper)
        html = "<html><title>Page</title><body><main>hello world</main></body></html>"
        with mock.patch.object(
            scraper, "fetch_url", mock.AsyncMock(return_value=("text/html", html))
        ):
            vid = await scraper.store_webpage("https://example.com")
        got = db.get_vector(vid)
        assert got is not None
        assert got[1]["url"] == "https://example.com"
        assert got[1]["source"] == "webscraper"
        assert "hello world" in got[1]["content"]


class TestSocialMedia:
    async def test_demo_search_all_platforms(self, db):
        plugin = SocialMediaPlugin(db)
        out = await plugin.search_posts("jax tpu", limit=3)
        assert set(out) == {"twitter", "reddit", "facebook"}
        assert len(out["twitter"]) == 3
        assert out["twitter"][0]["demo"] is True

    async def test_cache_hits(self, db):
        plugin = SocialMediaPlugin(db)
        await plugin.search_platform("twitter", "q", 2)
        await plugin.search_platform("twitter", "q", 2)
        assert plugin._stats["cache_hits"] == 1
        assert plugin._stats["searches"] == 1

    async def test_profile_and_trends(self, db):
        plugin = SocialMediaPlugin(db)
        profile = await plugin.get_profile("reddit", "someone")
        assert profile["username"] == "someone" and profile["demo"]
        trends = await plugin.get_trends()
        assert len(trends) == 10

    async def test_store_posts_pipeline(self, db):
        db.config.set("OLLAMA_DEMO", True)
        db.register_plugin(OllamaPlugin(db))
        plugin = SocialMediaPlugin(db)
        db.register_plugin(plugin)
        ids = await plugin.store_posts("topic", platforms=["twitter"], limit=2)
        assert len(ids) == 2
        assert db.get_vector(ids[0])[1]["platform"] == "twitter"

    async def test_unknown_platform_error_isolated(self, db):
        plugin = SocialMediaPlugin(db)
        out = await plugin.search_posts("q", platforms=["twitter", "myspace"])
        assert "error" in out["myspace"]
        assert isinstance(out["twitter"], list)


class TestSocialMediaSDKPaths:
    """Real SDK paths exercised with fake modules injected into
    sys.modules — the reference's own test style (reference
    tests/test_plugins.py:108-131 mocks network the same way)."""

    def _twitter_plugin(self, db):
        db.config.set("SOCIAL_MEDIA_TWITTER_BEARER_TOKEN", "tok")
        return SocialMediaPlugin(db)

    async def test_twitter_search_normalizes(self, db):
        import sys
        from types import SimpleNamespace as NS
        import datetime

        created = datetime.datetime(2024, 1, 1, tzinfo=datetime.timezone.utc)
        tweets = [
            NS(id=11, text="hello jax", author_id=7,
               public_metrics={"like_count": 3}, created_at=created),
        ]
        users = [NS(id=7, name="Ada", username="ada")]
        client = mock.Mock()
        client.search_recent_tweets.return_value = NS(
            data=tweets, includes={"users": users}
        )
        fake_tweepy = mock.Mock()
        fake_tweepy.Client.return_value = client
        with mock.patch.dict(sys.modules, {"tweepy": fake_tweepy}):
            plugin = self._twitter_plugin(db)
            posts = await plugin.search_platform("twitter", "jax", 5)
        assert posts == [{
            "id": "11", "platform": "twitter", "author": "ada",
            "content": "hello jax", "likes": 3,
            "timestamp": created.timestamp(),
        }]
        fake_tweepy.Client.assert_called_once_with(bearer_token="tok")

    async def test_reddit_search_normalizes(self, db):
        import sys
        from types import SimpleNamespace as NS

        subs = [NS(id="abc", title="TPUs", selftext="fast", author="bob",
                   score=42, created_utc=1700000000.0, subreddit="ml",
                   url="https://r.example/abc")]
        subreddit = mock.Mock()
        subreddit.search.return_value = subs
        client = mock.Mock()
        client.subreddit.return_value = subreddit
        fake_praw = mock.Mock()
        fake_praw.Reddit.return_value = client
        db.config.set("SOCIAL_MEDIA_REDDIT_CLIENT_ID", "id")
        db.config.set("SOCIAL_MEDIA_REDDIT_CLIENT_SECRET", "sec")
        with mock.patch.dict(sys.modules, {"praw": fake_praw}):
            plugin = SocialMediaPlugin(db)
            posts = await plugin.search_platform("reddit", "tpu", 5)
        assert posts[0]["id"] == "abc"
        assert posts[0]["content"] == "TPUs\nfast"
        assert posts[0]["likes"] == 42
        client.subreddit.assert_called_with("all")
        subreddit.search.assert_called_once_with("tpu", limit=5)

    async def test_facebook_search_normalizes(self, db):
        import sys

        client = mock.Mock()
        client.get_object.return_value = {
            "data": [{"id": "f1", "message": "hi",
                      "from": {"name": "Zed"},
                      "created_time": "2024-01-01T00:00:00Z"}]
        }
        fake_fb = mock.Mock()
        fake_fb.GraphAPI.return_value = client
        db.config.set("SOCIAL_MEDIA_FACEBOOK_ACCESS_TOKEN", "tok")
        with mock.patch.dict(sys.modules, {"facebook": fake_fb}):
            plugin = SocialMediaPlugin(db)
            posts = await plugin.search_platform("facebook", "q", 5)
        assert posts[0] == {
            "id": "f1", "platform": "facebook", "author": "Zed",
            "content": "hi", "likes": 0,
            "timestamp": "2024-01-01T00:00:00Z",
        }
        fake_fb.GraphAPI.assert_called_once_with(access_token="tok")

    async def test_twitter_profile(self, db):
        import sys
        from types import SimpleNamespace as NS

        client = mock.Mock()
        client.get_user.return_value = NS(data=NS(
            username="ada", name="Ada L",
            public_metrics={"followers_count": 99}, description="math",
        ))
        fake_tweepy = mock.Mock()
        fake_tweepy.Client.return_value = client
        with mock.patch.dict(sys.modules, {"tweepy": fake_tweepy}):
            plugin = self._twitter_plugin(db)
            prof = await plugin.get_profile("twitter", "ada")
        assert prof["followers"] == 99 and prof["display_name"] == "Ada L"

    async def test_reddit_trends(self, db):
        import sys
        from types import SimpleNamespace as NS

        subreddit = mock.Mock()
        subreddit.hot.return_value = [
            NS(title="Top post", score=500, subreddit="popular"),
        ]
        client = mock.Mock()
        client.subreddit.return_value = subreddit
        fake_praw = mock.Mock()
        fake_praw.Reddit.return_value = client
        db.config.set("SOCIAL_MEDIA_REDDIT_CLIENT_ID", "id")
        db.config.set("SOCIAL_MEDIA_REDDIT_CLIENT_SECRET", "sec")
        with mock.patch.dict(sys.modules, {"praw": fake_praw}):
            plugin = SocialMediaPlugin(db)
            trends = await plugin.get_trends("reddit")
        assert trends[0]["name"] == "Top post" and trends[0]["volume"] == 500

    async def test_missing_sdk_raises_install_hint(self, db):
        import sys

        db.config.set("SOCIAL_MEDIA_REDDIT_CLIENT_ID", "id")
        db.config.set("SOCIAL_MEDIA_REDDIT_CLIENT_SECRET", "sec")
        with mock.patch.dict(sys.modules, {"praw": None}):
            plugin = SocialMediaPlugin(db)
            with pytest.raises(PluginError, match="praw is required"):
                await plugin._search_real("reddit", "q", 3)

    async def test_sdk_error_isolated_in_fanout(self, db):
        import sys

        db.config.set("SOCIAL_MEDIA_TWITTER_BEARER_TOKEN", "tok")
        boom = mock.Mock()
        boom.Client.return_value.search_recent_tweets.side_effect = (
            RuntimeError("rate limited")
        )
        with mock.patch.dict(sys.modules, {"tweepy": boom}):
            plugin = SocialMediaPlugin(db)
            out = await plugin.search_posts("q", platforms=["twitter", "reddit"])
        assert "error" in out["twitter"] and "rate limited" in out["twitter"]["error"]
        assert isinstance(out["reddit"], list)  # demo fallback unaffected


class TestWebScraperPDF:
    def _pdf_plugin(self, db):
        return WebScraperPlugin(db)

    def test_extract_pdf_gated(self, db):
        import sys

        plugin = self._pdf_plugin(db)
        with mock.patch.dict(sys.modules, {"pypdf": None, "PyPDF2": None}):
            with pytest.raises(PluginError, match="PDF extraction unavailable"):
                plugin.extract_pdf(b"%PDF-1.4 fake")

    def test_extract_pdf_with_fake_reader(self, db):
        import sys

        page1 = mock.Mock()
        page1.extract_text.return_value = "Page one."
        page2 = mock.Mock()
        page2.extract_text.return_value = "Page two."
        fake_mod = mock.Mock()
        fake_mod.PdfReader.return_value = mock.Mock(pages=[page1, page2])
        plugin = self._pdf_plugin(db)
        with mock.patch.dict(sys.modules, {"pypdf": fake_mod}):
            text = plugin.extract_pdf(b"%PDF-1.4 fake")
        assert text == "Page one.\n\nPage two."

    async def test_fetch_url_detects_pdf(self, db):
        import sys

        plugin = self._pdf_plugin(db)
        plugin.respect_robots = False

        class FakeResp:
            status = 200
            headers = {"Content-Type": "application/pdf"}
            charset = None

            async def read(self):
                return b"%PDF-1.4 fake"

            async def __aenter__(self):
                return self

            async def __aexit__(self, *a):
                return False

        session = mock.Mock()
        session.get = mock.Mock(return_value=FakeResp())
        plugin._session = session
        page = mock.Mock()
        page.extract_text.return_value = "PDF body text"
        fake_mod = mock.Mock()
        fake_mod.PdfReader.return_value = mock.Mock(pages=[page])
        with mock.patch.dict(sys.modules, {"pypdf": fake_mod}):
            ctype, text = await plugin.fetch_url("https://x.example/doc.pdf")
        assert ctype == "application/pdf"
        assert text == "PDF body text"


class TestFacadePlugins:
    """The facade's plugin cases of test_facade.py and test_store.py,
    on the port."""

    def test_register_plugin(self, db):
        class Dummy(WDBXPlugin):
            name = "dummy"
            description = "d"
            version = "1.0"

        db.register_plugin(Dummy(db))
        assert db.get_plugin("dummy") is not None
        assert db.get_plugin("missing") is None

    def test_version_and_plugins_attrs(self, db):
        assert isinstance(db.version, str) and db.version
        assert db.plugins == {}

        class P(WDBXPlugin):
            name = "p1"
            description = "d"
            version = "1"

        db.register_plugin(P(db))
        assert "p1" in db.plugins

    def test_local_embeddings_plugin(self, temp_dir):
        import asyncio

        from wdbx_tpu_torch.plugins.local_embeddings import (
            LocalEmbeddingsPlugin,
        )

        db = WDBX(vector_dimension=16, data_dir=temp_dir,
                  enable_plugins=False)
        db.config.set("SENTENCETRANSFORMERS_DEMO", True)  # demo is opt-in
        plugin = LocalEmbeddingsPlugin(db)
        assert plugin._demo()
        e1 = asyncio.run(plugin.create_embedding("hello"))
        e2 = asyncio.run(plugin.create_embedding("hello"))
        e3 = asyncio.run(plugin.create_embedding("world"))
        assert e1 == e2 and e1 != e3 and len(e1) == 16
        assert abs(np.linalg.norm(e1) - 1.0) < 1e-5
        batch = asyncio.run(
            plugin.create_embeddings_batch(["hello", "world"])
        )
        assert batch[0] == e1 and batch[1] == e3
        # without the demo flag or a model path, the plugin refuses loudly
        db.config.set("SENTENCETRANSFORMERS_DEMO", False)
        strict = LocalEmbeddingsPlugin(db)
        with pytest.raises(PluginError, match="no local model configured"):
            asyncio.run(strict.create_embedding("x"))

    def test_default_arguments_load_the_builtin_plugins(self, temp_dir):
        """WDBX() with default arguments: plugins on (the port's own
        builtins, the demo embedder among them) on the CPU when asked;
        with no device it wants the card and raises without one.
        enable_distributed builds the shard engine (the mesh layer)."""
        import torch

        db = WDBX(data_dir=temp_dir)
        assert set(db.plugins) == {
            "ollama", "lmstudio", "sentencetransformers", "webscraper",
            "social_media",
        }
        for plugin in db.plugins.values():
            assert type(plugin).__module__.startswith(
                "wdbx_tpu_torch.plugins."
            )
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                _WDBX(data_dir=temp_dir + "/card")
        mesh = WDBX(data_dir=temp_dir + "/mesh", enable_distributed=True)
        assert mesh.shard_engine is not None

    def test_entry_point_group_is_the_ports_own(self, db, monkeypatch):
        """External plugins come from the ``wdbx_tpu_torch.plugins``
        group, never from the JAX package's ``wdbx_tpu.plugins``."""
        import importlib.metadata as md

        asked = []

        def fake_entry_points(group):
            asked.append(group)
            return []

        monkeypatch.setattr(md, "entry_points", fake_entry_points)
        PluginManager(db).load_entry_points()
        assert asked == ["wdbx_tpu_torch.plugins"]


@pytest.mark.parametrize("dim", [1, 8, 384, 1536])
def test_demo_embedding_bit_identical_to_jax(dim):
    from wdbx_tpu.plugins.base import demo_embedding as jax_demo
    from wdbx_tpu_torch.plugins.base import demo_embedding

    for text in ("", "hello", "world", "ünïcode ✓", "x" * 1000):
        got = np.asarray(demo_embedding(text, dim), np.float64)
        want = np.asarray(jax_demo(text, dim), np.float64)
        assert got.tobytes() == want.tobytes()
