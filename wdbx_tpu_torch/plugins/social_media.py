"""Social media plugin: unified Twitter/Reddit/Facebook search + storage.

Behavioral parity with the reference social plugin (reference
wdbx/plugins/social_media.py): a unified ``search_posts`` fanning out
per-platform with exception isolation (:307-376), TTL-cached calls
keyed on method+args (:260-305, default 300s), per-platform search /
profile / trends operations, embedding delegation (:1113-1161), four
CLI commands (:1163-1203), and — the load-bearing piece — **demo mode**
(:151-153 etc.): with no credentials every operation returns
deterministic mock data, so the whole plugin is testable offline. The
real tweepy/praw/facebook SDKs are optional dependencies, so demo mode
is the default and SDK-backed paths are gated on import success.

Torch port: ``wdbx_tpu/plugins/social_media.py`` with its imports repointed to
``wdbx_tpu_torch``; the behaviour is unchanged.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import time
from typing import Any

from wdbx_tpu_torch.plugins.base import PluginError, WDBXPlugin

logger = logging.getLogger("wdbx_tpu_torch.plugins.social_media")

PLATFORMS = ("twitter", "reddit", "facebook")


def _mock_id(*parts: Any) -> str:
    return hashlib.blake2b(
        json.dumps(parts, default=str).encode(), digest_size=6
    ).hexdigest()


class SocialMediaPlugin(WDBXPlugin):
    @property
    def name(self) -> str:
        return "social_media"

    @property
    def description(self) -> str:
        return "Search and store social media content (Twitter/Reddit/Facebook)"

    @property
    def version(self) -> str:
        return "0.1.0"

    def __init__(self, wdbx):
        super().__init__(wdbx)
        self.cache_ttl = float(self.get_config("CACHE_TTL", 300))
        self._cache: dict[str, tuple[float, Any]] = {}
        self._stats = {"searches": 0, "cache_hits": 0, "posts_stored": 0}
        # Demo mode whenever credentials are absent (reference behavior).
        self.twitter_token = self.get_config("TWITTER_BEARER_TOKEN", None)
        self.twitter_api_key = self.get_config("TWITTER_API_KEY", None)
        self.twitter_api_secret = self.get_config("TWITTER_API_SECRET", None)
        self.twitter_access_token = self.get_config(
            "TWITTER_ACCESS_TOKEN", None
        )
        self.twitter_access_secret = self.get_config(
            "TWITTER_ACCESS_SECRET", None
        )
        self.reddit_id = self.get_config("REDDIT_CLIENT_ID", None)
        self.reddit_secret = self.get_config("REDDIT_CLIENT_SECRET", None)
        self.reddit_agent = self.get_config(
            "REDDIT_USER_AGENT", "wdbx-tpu/0.1"
        )
        self.facebook_token = self.get_config("FACEBOOK_ACCESS_TOKEN", None)
        self._clients: dict[str, Any] = {}

    def _demo(self, platform: str) -> bool:
        cred = {
            "twitter": self.twitter_token or self.twitter_api_key,
            "reddit": self.reddit_id,
            "facebook": self.facebook_token,
        }[platform]
        return not cred

    # -- SDK clients ---------------------------------------------------------
    # Lazily built, gated on the SDK importing; missing SDKs raise a
    # PluginError with the install hint, matching the reference's
    # _initialize_* behavior (reference wdbx/plugins/social_media.py:150-256).
    def _client(self, platform: str):
        client = self._clients.get(platform)
        if client is not None:
            return client
        if platform == "twitter":
            try:
                import tweepy
            except ImportError:
                raise PluginError(
                    "tweepy is required for Twitter integration "
                    "(pip install tweepy)"
                )
            if (self.twitter_api_key and self.twitter_api_secret
                    and self.twitter_access_token
                    and self.twitter_access_secret):
                client = tweepy.Client(
                    consumer_key=self.twitter_api_key,
                    consumer_secret=self.twitter_api_secret,
                    access_token=self.twitter_access_token,
                    access_token_secret=self.twitter_access_secret,
                )
            elif self.twitter_token:
                client = tweepy.Client(bearer_token=self.twitter_token)
            else:
                raise PluginError("missing Twitter credentials")
        elif platform == "reddit":
            try:
                import praw
            except ImportError:
                raise PluginError(
                    "praw is required for Reddit integration "
                    "(pip install praw)"
                )
            if not (self.reddit_id and self.reddit_secret):
                raise PluginError("missing Reddit credentials")
            client = praw.Reddit(
                client_id=self.reddit_id,
                client_secret=self.reddit_secret,
                user_agent=self.reddit_agent,
            )
        elif platform == "facebook":
            try:
                import facebook
            except ImportError:
                raise PluginError(
                    "facebook-sdk is required for Facebook integration "
                    "(pip install facebook-sdk)"
                )
            if not self.facebook_token:
                raise PluginError("missing Facebook credentials")
            client = facebook.GraphAPI(access_token=self.facebook_token)
        else:
            raise PluginError(f"unknown platform: {platform}")
        self._clients[platform] = client
        return client

    # -- cache -------------------------------------------------------------
    def _cached(self, key: str):
        hit = self._cache.get(key)
        if hit and time.time() - hit[0] < self.cache_ttl:
            self._stats["cache_hits"] += 1
            return hit[1]
        return None

    def _put_cache(self, key: str, value: Any) -> None:
        self._cache[key] = (time.time(), value)

    # -- mock backends -----------------------------------------------------
    def _mock_posts(self, platform: str, query: str, limit: int) -> list[dict]:
        return [
            {
                "id": _mock_id(platform, query, i),
                "platform": platform,
                "author": f"demo_user_{i}",
                "content": f"[demo:{platform}] post {i} about {query}",
                "likes": (i * 17) % 101,
                "timestamp": time.time() - i * 3600,
                "demo": True,
            }
            for i in range(limit)
        ]

    def _mock_profile(self, platform: str, username: str) -> dict:
        return {
            "platform": platform,
            "username": username,
            "display_name": username.title(),
            "followers": int(_mock_id(platform, username)[:4], 16),
            "bio": f"[demo] profile of {username} on {platform}",
            "demo": True,
        }

    def _mock_trends(self, platform: str, location: str) -> list[dict]:
        return [
            {"name": f"#demo-trend-{i}", "volume": 1000 - i * 97, "demo": True}
            for i in range(10)
        ]

    # -- platform operations ----------------------------------------------
    async def search_platform(
        self, platform: str, query: str, limit: int = 10
    ) -> list[dict]:
        if platform not in PLATFORMS:
            raise PluginError(f"unknown platform: {platform}")
        key = f"search:{platform}:{query}:{limit}"
        cached = self._cached(key)
        if cached is not None:
            return cached
        self._stats["searches"] += 1
        if self._demo(platform):
            posts = self._mock_posts(platform, query, limit)
        else:
            posts = await self._search_real(platform, query, limit)
        self._put_cache(key, posts)
        return posts

    async def _search_real(self, platform: str, query: str, limit: int):
        """SDK-backed search, normalized into the unified post schema
        (reference behavior: wdbx/plugins/social_media.py:378-614). The
        SDKs are synchronous, so calls run in a worker thread."""
        fn = {
            "twitter": self._search_twitter,
            "reddit": self._search_reddit,
            "facebook": self._search_facebook,
        }[platform]
        try:
            return await asyncio.to_thread(fn, query, limit)
        except PluginError:
            raise
        except Exception as e:
            raise PluginError(f"error searching {platform}: {e}")

    def _search_twitter(self, query: str, limit: int) -> list[dict]:
        client = self._client("twitter")
        resp = client.search_recent_tweets(
            query=query,
            max_results=min(max(limit, 10), 100),
            tweet_fields=["created_at", "public_metrics"],
            user_fields=["name", "username"],
            expansions=["author_id"],
        )
        users = {}
        includes = getattr(resp, "includes", None) or {}
        for user in includes.get("users", []):
            users[user.id] = user
        posts = []
        for tweet in (resp.data or [])[:limit]:
            user = users.get(getattr(tweet, "author_id", None))
            metrics = getattr(tweet, "public_metrics", None) or {}
            created = getattr(tweet, "created_at", None)
            posts.append({
                "id": str(tweet.id),
                "platform": "twitter",
                "author": getattr(user, "username", None),
                "content": tweet.text,
                "likes": metrics.get("like_count", 0),
                "timestamp": created.timestamp() if created else None,
            })
        return posts

    def _search_reddit(self, query: str, limit: int) -> list[dict]:
        client = self._client("reddit")
        posts = []
        for sub in client.subreddit("all").search(query, limit=limit):
            created = getattr(sub, "created_utc", None)
            posts.append({
                "id": str(sub.id),
                "platform": "reddit",
                "author": str(getattr(sub, "author", "")) or None,
                "content": sub.title + (
                    "\n" + sub.selftext
                    if getattr(sub, "selftext", "") else ""
                ),
                "likes": getattr(sub, "score", 0),
                "timestamp": created,
                "subreddit": str(getattr(sub, "subreddit", "")),
                "url": getattr(sub, "url", None),
            })
        return posts

    def _search_facebook(self, query: str, limit: int) -> list[dict]:
        client = self._client("facebook")
        resp = client.get_object(
            id="search", q=query, type="post", limit=limit,
            fields="id,message,created_time,from",
        )
        posts = []
        for post in resp.get("data", [])[:limit]:
            posts.append({
                "id": str(post.get("id")),
                "platform": "facebook",
                "author": (post.get("from") or {}).get("name"),
                "content": post.get("message", ""),
                "likes": 0,  # requires extra permissions/fields
                "timestamp": post.get("created_time"),
            })
        return posts

    async def search_posts(
        self,
        query: str,
        platforms: list[str] | None = None,
        limit: int = 10,
    ) -> dict[str, Any]:
        """Fan out across platforms; per-platform failures become
        ``{"error": ...}`` entries (reference
        wdbx/plugins/social_media.py:307-376)."""
        platforms = platforms or list(PLATFORMS)
        results = await asyncio.gather(
            *(self.search_platform(p, query, limit) for p in platforms),
            return_exceptions=True,
        )
        out: dict[str, Any] = {}
        for platform, result in zip(platforms, results):
            if isinstance(result, BaseException):
                out[platform] = {"error": str(result)}
            else:
                out[platform] = result
        return out

    async def get_profile(self, platform: str, username: str) -> dict:
        if platform not in PLATFORMS:
            raise PluginError(f"unsupported platform: {platform}")
        key = f"profile:{platform}:{username}"
        cached = self._cached(key)
        if cached is not None:
            return cached
        if self._demo(platform):
            profile = self._mock_profile(platform, username)
        else:
            profile = await asyncio.to_thread(
                self._profile_real, platform, username
            )
        self._put_cache(key, profile)
        return profile

    def _profile_real(self, platform: str, username: str) -> dict:
        """SDK profile lookup (reference behavior:
        wdbx/plugins/social_media.py:617-870)."""
        try:
            if platform == "twitter":
                client = self._client("twitter")
                resp = client.get_user(
                    username=username,
                    user_fields=["description", "public_metrics", "name"],
                )
                u = resp.data
                if u is None:
                    raise PluginError(f"user not found: {username}")
                metrics = getattr(u, "public_metrics", None) or {}
                return {
                    "platform": "twitter",
                    "username": u.username,
                    "display_name": u.name,
                    "followers": metrics.get("followers_count", 0),
                    "bio": getattr(u, "description", "") or "",
                }
            if platform == "reddit":
                client = self._client("reddit")
                u = client.redditor(username)
                return {
                    "platform": "reddit",
                    "username": username,
                    "display_name": getattr(u, "name", username),
                    "followers": 0,  # reddit has no follower concept
                    "karma": getattr(u, "link_karma", 0)
                    + getattr(u, "comment_karma", 0),
                    "bio": "",
                }
            if platform == "facebook":
                client = self._client("facebook")
                u = client.get_object(
                    username, fields="id,name,username,about"
                )
                return {
                    "platform": "facebook",
                    "username": u.get("username", username),
                    "display_name": u.get("name", username),
                    "followers": 0,
                    "bio": u.get("about", ""),
                }
        except PluginError:
            raise
        except Exception as e:
            raise PluginError(f"error fetching {platform} profile: {e}")
        raise PluginError(f"unknown platform: {platform}")

    async def get_trends(self, platform: str = "twitter", location: str = "global") -> list[dict]:
        if platform not in PLATFORMS:
            raise PluginError(f"unsupported platform: {platform}")
        key = f"trends:{platform}:{location}"
        cached = self._cached(key)
        if cached is not None:
            return cached
        if self._demo(platform):
            trends = self._mock_trends(platform, location)
        else:
            trends = await asyncio.to_thread(
                self._trends_real, platform, location
            )
        self._put_cache(key, trends)
        return trends

    def _trends_real(self, platform: str, location: str) -> list[dict]:
        """SDK trends (reference behavior:
        wdbx/plugins/social_media.py:905-1110). Twitter trends need the
        v1 API (OAuth 1.0a); Reddit trends are r/popular hot posts;
        Facebook has no public trends API."""
        try:
            if platform == "twitter":
                import tweepy

                if not (self.twitter_api_key and self.twitter_api_secret
                        and self.twitter_access_token
                        and self.twitter_access_secret):
                    raise PluginError(
                        "Twitter OAuth 1.0a credentials required for trends"
                    )
                api = self._clients.get("twitter_v1")
                if api is None:
                    auth = tweepy.OAuth1UserHandler(
                        self.twitter_api_key, self.twitter_api_secret,
                        self.twitter_access_token, self.twitter_access_secret,
                    )
                    api = tweepy.API(auth)
                    self._clients["twitter_v1"] = api
                woeid = 1  # worldwide
                if location and location != "global":
                    try:
                        woeid = int(location)
                    except ValueError:
                        for loc in api.available_trends():
                            if location.lower() in loc["name"].lower():
                                woeid = loc["woeid"]
                                break
                        else:
                            raise PluginError(f"location not found: {location}")
                trends = api.get_place_trends(woeid)[0]["trends"]
                return [
                    {"name": t["name"], "volume": t.get("tweet_volume")}
                    for t in trends[:10]
                ]
            if platform == "reddit":
                client = self._client("reddit")
                return [
                    {
                        "name": sub.title,
                        "volume": getattr(sub, "score", 0),
                        "subreddit": str(getattr(sub, "subreddit", "")),
                    }
                    for sub in client.subreddit("popular").hot(limit=10)
                ]
            raise PluginError(f"{platform} has no public trends API")
        except PluginError:
            raise
        except Exception as e:
            raise PluginError(f"error fetching {platform} trends: {e}")

    # -- embedding + storage ----------------------------------------------
    async def create_embedding(self, text: str) -> list[float]:
        from wdbx_tpu_torch.plugins import iter_embedding_plugins

        for plugin in iter_embedding_plugins(self.wdbx.plugin_manager):
            if plugin is self:
                continue
            try:
                return await plugin.create_embedding(text)
            except Exception:
                continue
        raise PluginError("no embedding provider available for social_media")

    async def store_posts(
        self, query: str, platforms: list[str] | None = None, limit: int = 10
    ) -> list[str]:
        by_platform = await self.search_posts(query, platforms, limit)
        ids = []
        for platform, posts in by_platform.items():
            if isinstance(posts, dict):  # error entry
                continue
            for post in posts:
                embedding = await self.create_embedding(post["content"])
                vid = await self.wdbx.vector_store_async(
                    embedding,
                    {
                        "source": "social_media",
                        "platform": platform,
                        "query": query,
                        **post,
                    },
                )
                ids.append(vid)
                self._stats["posts_stored"] += 1
        return ids

    # -- CLI ---------------------------------------------------------------
    def register_commands(self, cli) -> None:
        cli.register_command(
            "social-search", self._cli_search, "Search social media posts"
        )
        cli.register_command(
            "social-profile", self._cli_profile, "Look up a social profile"
        )
        cli.register_command(
            "social-trends", self._cli_trends, "Show trending topics"
        )
        cli.register_command(
            "social-store", self._cli_store, "Search posts and store them"
        )

    async def _cli_search(self, args):
        if not args:
            print("usage: social-search <query...>")
            return 1
        results = await self.search_posts(" ".join(args), limit=5)
        print(json.dumps(results, indent=2, default=str))

    async def _cli_profile(self, args):
        if len(args) < 2:
            print("usage: social-profile <platform> <username>")
            return 1
        print(json.dumps(await self.get_profile(args[0], args[1]), indent=2))

    async def _cli_trends(self, args):
        platform = args[0] if args else "twitter"
        print(json.dumps(await self.get_trends(platform), indent=2))

    async def _cli_store(self, args):
        if not args:
            print("usage: social-store <query...>")
            return 1
        ids = await self.store_posts(" ".join(args), limit=5)
        print(f"stored {len(ids)} posts")

    def get_stats(self) -> dict[str, Any]:
        stats = super().get_stats()
        stats.update(
            self._stats,
            cache_entries=len(self._cache),
            demo_platforms=[p for p in PLATFORMS if self._demo(p)],
        )
        return stats
