"""Web scraper plugin: fetch → extract → embed → store pipelines.

Behavioral parity with the reference scraper (reference
wdbx/plugins/webscraper.py): robots.txt respect with a 24h cache
(:348-407), per-domain rate limiting (:409-435), HTML extraction that
strips script/style/nav/footer/header and prefers main/article/#content
(:222-268), same-domain link following bounded by MAX_DEPTH/MAX_LINKS
(:303-346), BFS ``crawl`` with a concurrency semaphore and ``max_pages``
(:469-555), embedding delegation to another plugin (:437-467),
``store_webpage``/``store_website`` piping extract→embed→store with
url/source/time metadata (:593-672), and two CLI commands (:674-697).
PDF responses are detected in ``fetch_url`` and extracted per-page via
pypdf/PyPDF2 (:270-301), gated on the library importing (not in this
image; a fake module in tests/test_plugins.py exercises the path).

Torch port: ``wdbx_tpu/plugins/webscraper.py`` with its imports repointed to
``wdbx_tpu_torch``; the behaviour is unchanged.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any
from urllib import robotparser
from urllib.parse import urljoin, urlparse

from wdbx_tpu_torch.plugins.base import PluginError, WDBXPlugin

logger = logging.getLogger("wdbx_tpu_torch.plugins.webscraper")


class WebScraperPlugin(WDBXPlugin):
    @property
    def name(self) -> str:
        return "webscraper"

    @property
    def description(self) -> str:
        return "Scrape web content, embed it, and store it in the database"

    @property
    def version(self) -> str:
        return "0.1.0"

    def __init__(self, wdbx):
        super().__init__(wdbx)
        self.user_agent = self.get_config("USER_AGENT", "wdbx-tpu-scraper/0.1")
        self.timeout = float(self.get_config("TIMEOUT", 30))
        self.max_depth = int(self.get_config("MAX_DEPTH", 2))
        self.max_links = int(self.get_config("MAX_LINKS", 50))
        self.rate_limit_s = float(self.get_config("RATE_LIMIT", 1.0))
        self.respect_robots = bool(self.get_config("RESPECT_ROBOTS", True))
        self.concurrency = int(self.get_config("CONCURRENCY", 5))
        self._session = None
        self._robots: dict[str, tuple[float, robotparser.RobotFileParser]] = {}
        self._last_fetch: dict[str, float] = {}
        self._stats = {"pages_fetched": 0, "pages_stored": 0, "errors": 0}

    async def initialize(self) -> bool:
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
                timeout=aiohttp.ClientTimeout(total=self.timeout),
                headers={"User-Agent": self.user_agent},
            )
        return self._session

    # -- politeness --------------------------------------------------------
    async def _robots_allows(self, url: str) -> bool:
        if not self.respect_robots:
            return True
        domain = urlparse(url).netloc
        cached = self._robots.get(domain)
        if cached is None or time.time() - cached[0] > 86400:  # 24h cache
            rp = robotparser.RobotFileParser()
            robots_url = f"{urlparse(url).scheme}://{domain}/robots.txt"
            try:
                session = self._require_session()
                async with session.get(robots_url) as resp:
                    if resp.status == 200:
                        rp.parse((await resp.text()).splitlines())
                    else:
                        rp.allow_all = True
            except Exception:
                rp.allow_all = True
            self._robots[domain] = (time.time(), rp)
            cached = self._robots[domain]
        return cached[1].can_fetch(self.user_agent, url)

    async def _rate_limit(self, url: str) -> None:
        # RESERVE the next fetch window before sleeping: concurrent
        # crawl() coroutines that merely check-then-sleep all compute
        # the same wait and fire together at n x the configured rate.
        domain = urlparse(url).netloc
        now = time.time()
        slot = max(self._last_fetch.get(domain, 0.0) + self.rate_limit_s, now)
        self._last_fetch[domain] = slot  # atomic under the event loop
        wait = slot - now
        if wait > 0:
            await asyncio.sleep(wait)

    # -- fetch + extract ---------------------------------------------------
    async def fetch_url(self, url: str) -> tuple[str, str]:
        """Returns (content_type, body_text). PDF responses are detected
        by Content-Type or .pdf suffix and come back as extracted text
        (reference wdbx/plugins/webscraper.py:270-301)."""
        if not await self._robots_allows(url):
            raise PluginError(f"robots.txt disallows {url}")
        await self._rate_limit(url)
        session = self._require_session()
        try:
            async with session.get(url) as resp:
                if resp.status != 200:
                    raise PluginError(f"{url} returned {resp.status}")
                ctype = resp.headers.get("Content-Type", "text/html")
                body = await resp.read()
                self._stats["pages_fetched"] += 1
                if "application/pdf" in ctype.lower() or (
                    url.split("?")[0].lower().endswith(".pdf")
                ):
                    return "application/pdf", self.extract_pdf(body)
                return ctype, body.decode(resp.charset or "utf-8", "replace")
        except PluginError:
            self._stats["errors"] += 1
            raise
        except Exception as e:
            self._stats["errors"] += 1
            raise PluginError(f"fetch failed for {url}: {e}") from e

    def extract_pdf(self, data: bytes) -> str:
        """Per-page text extraction, gated on a PDF library importing
        (pypdf, falling back to the older PyPDF2 namespace — the
        reference uses PyPDF2, wdbx/plugins/webscraper.py:270-301)."""
        import io

        try:
            try:
                from pypdf import PdfReader
            except ImportError:
                from PyPDF2 import PdfReader
        except ImportError:
            raise PluginError(
                "pypdf/PyPDF2 not installed; PDF extraction unavailable"
            )
        try:
            reader = PdfReader(io.BytesIO(data))
            return "\n\n".join(
                (page.extract_text() or "") for page in reader.pages
            ).strip()
        except PluginError:
            raise
        except Exception as e:
            raise PluginError(f"PDF extraction failed: {e}")

    def extract_content(self, html: str) -> dict[str, Any]:
        """Main-content extraction (reference scheme: strip chrome, prefer
        main/article/#content)."""
        from bs4 import BeautifulSoup

        soup = BeautifulSoup(html, "html.parser")
        title = soup.title.get_text(strip=True) if soup.title else ""
        for tag in soup(["script", "style", "nav", "footer", "header"]):
            tag.decompose()
        main = (
            soup.find("main")
            or soup.find("article")
            or soup.find(id="content")
            or soup.body
            or soup
        )
        text = " ".join(main.get_text(separator=" ").split())
        return {"title": title, "content": text}

    def extract_links(self, html: str, base_url: str) -> list[str]:
        """Same-domain links, bounded by max_links."""
        from bs4 import BeautifulSoup

        soup = BeautifulSoup(html, "html.parser")
        base_domain = urlparse(base_url).netloc
        links: list[str] = []
        for a in soup.find_all("a", href=True):
            url = urljoin(base_url, a["href"]).split("#")[0]
            if urlparse(url).netloc == base_domain and url not in links:
                links.append(url)
            if len(links) >= self.max_links:
                break
        return links

    # -- embedding delegation ---------------------------------------------
    async def create_embedding(self, text: str) -> list[float]:
        from wdbx_tpu_torch.plugins import iter_embedding_plugins

        for plugin in iter_embedding_plugins(self.wdbx.plugin_manager):
            if plugin is self:
                continue
            try:
                return await plugin.create_embedding(text)
            except Exception:
                continue
        raise PluginError("no embedding provider available for webscraper")

    # -- pipelines ---------------------------------------------------------
    async def store_webpage(
        self, url: str, metadata: dict[str, Any] | None = None
    ) -> str:
        ctype, html = await self.fetch_url(url)
        if ctype == "application/pdf":
            # fetch_url already extracted the text
            extracted = {"title": url.rsplit("/", 1)[-1], "content": html}
        else:
            extracted = self.extract_content(html)
        if not extracted["content"]:
            raise PluginError(f"no content extracted from {url}")
        embedding = await self.create_embedding(extracted["content"][:2000])
        meta = {
            "url": url,
            "title": extracted["title"],
            "source": "webscraper",
            "scraped_at": time.time(),
            "content": extracted["content"][:5000],
            **(metadata or {}),
        }
        vid = await self.wdbx.vector_store_async(embedding, meta)
        self._stats["pages_stored"] += 1
        return vid

    async def crawl(
        self, start_url: str, max_pages: int = 10
    ) -> list[dict[str, Any]]:
        """BFS with a concurrency semaphore (reference
        wdbx/plugins/webscraper.py:469-555)."""
        sem = asyncio.Semaphore(self.concurrency)
        seen: set[str] = set()
        frontier = [(start_url, 0)]
        results: list[dict[str, Any]] = []

        async def visit(url: str, depth: int):
            async with sem:
                try:
                    _, html = await self.fetch_url(url)
                except PluginError as e:
                    return url, depth, None, []
                content = self.extract_content(html)
                links = (
                    self.extract_links(html, url)
                    if depth < self.max_depth
                    else []
                )
                return url, depth, content, links

        while frontier and len(results) < max_pages:
            batch = frontier[: self.concurrency]
            frontier = frontier[self.concurrency:]
            # dedup within the batch too: two pages in one gather can
            # both link the same unvisited URL (it passes the `seen`
            # filter twice and gets fetched/stored twice)
            picked: dict[str, int] = {}
            for u, d in batch:
                if u not in seen and u not in picked:
                    picked[u] = d
            batch = list(picked.items())
            seen.update(picked)
            for url, depth, content, links in await asyncio.gather(
                *(visit(u, d) for u, d in batch)
            ):
                if content is not None:
                    results.append({"url": url, "depth": depth, **content})
                for link in links:
                    if link not in seen:
                        frontier.append((link, depth + 1))
                if len(results) >= max_pages:
                    break
        return results

    async def store_website(
        self, start_url: str, max_pages: int = 10
    ) -> list[str]:
        pages = await self.crawl(start_url, max_pages=max_pages)
        ids = []
        for page in pages:
            if not page["content"]:
                continue
            embedding = await self.create_embedding(page["content"][:2000])
            vid = await self.wdbx.vector_store_async(
                embedding,
                {
                    "url": page["url"],
                    "title": page["title"],
                    "source": "webscraper",
                    "scraped_at": time.time(),
                    "content": page["content"][:5000],
                },
            )
            ids.append(vid)
            self._stats["pages_stored"] += 1
        return ids

    # -- CLI ---------------------------------------------------------------
    def register_commands(self, cli) -> None:
        cli.register_command(
            "scrape", self._cli_scrape, "Scrape a URL and store its content"
        )
        cli.register_command(
            "crawl", self._cli_crawl, "Crawl a site and store its pages"
        )

    async def _cli_scrape(self, args):
        if not args:
            print("usage: scrape <url>")
            return 1
        vid = await self.store_webpage(args[0])
        print(f"stored: {vid}")

    async def _cli_crawl(self, args):
        if not args:
            print("usage: crawl <url> [max_pages]")
            return 1
        max_pages = int(args[1]) if len(args) > 1 else 10
        ids = await self.store_website(args[0], max_pages=max_pages)
        print(f"stored {len(ids)} pages")

    def get_stats(self) -> dict[str, Any]:
        stats = super().get_stats()
        stats.update(self._stats)
        return stats
