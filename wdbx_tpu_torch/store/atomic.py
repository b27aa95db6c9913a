"""Crash-atomic checkpoint generations (VERDICT r4 ask #5).

The reference writes every checkpoint file in place (reference
wdbx/core/vector_store.py:136-176, wdbx/core/indexing.py:317-344), so a
crash mid-save tears the checkpoint and its load path silently falls
back to a FRESH index (reference wdbx/core/indexing.py:309-315). This
store makes checkpoints load-bearing for ``heal()``/``recover()``, so a
torn save must never be observable. Protocol (LevelDB-style CURRENT
pointer over generation directories):

    data_dir/checkpoint/
        CURRENT.json          -> {"generation": N}
        g{N:06d}/             one COMPLETE checkpoint
            MANIFEST.json     {"generation": N, "files": [relpaths]}
            indices/...  metadata/...

``save()`` stages all files into ``g{N}.tmp/``, fsyncs them, writes the
manifest last, atomically renames the directory to ``g{N}``, fsyncs the
parent, atomically replaces ``CURRENT.json``, then garbage-collects
older generations. Every crash window leaves a loadable state:

  * during staging          -> CURRENT still names the previous
                               complete generation; ``*.tmp`` is GC'd;
  * between rename+CURRENT  -> previous generation loads (the new one
                               is complete but unreferenced; the next
                               save overwrites it);
  * after CURRENT           -> the new generation loads.

``load()`` verifies the manifest (every listed file exists); if the
CURRENT generation is damaged out-of-band it falls back to the newest
complete generation on disk instead of a fresh index.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Callable

logger = logging.getLogger("wdbx_tpu_torch.store")

_GEN_RE = re.compile(r"^g(\d{6})$")

#: test hook: called with a label at each protocol step so crash tests
#: can inject a failure (raise / os._exit) at an exact window.
CRASH_HOOK: Callable[[str], None] | None = None


def _hook(label: str) -> None:
    if CRASH_HOOK is not None:
        CRASH_HOOK(label)


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj: Any, fsync: bool = True) -> None:
    """tmp-file + fsync + ``os.replace`` + parent-dir fsync.
    ``fsync=False`` keeps the atomic replace but skips the forced
    flushes (benchmark mode — see CheckpointRoot)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(path) or ".")


class CheckpointRoot:
    """One store's generation directory set under ``<data_dir>/checkpoint``."""

    def __init__(self, root: str, fsync: bool = True):
        self.root = root
        self.fsync = fsync

    def gen_dir(self, gen: int) -> str:
        return os.path.join(self.root, f"g{gen:06d}")

    def _manifest_ok(self, gen_dir: str) -> bool:
        man_path = os.path.join(gen_dir, "MANIFEST.json")
        try:
            with open(man_path) as f:
                man = json.load(f)
            for rel in man["files"]:
                if not os.path.exists(os.path.join(gen_dir, rel)):
                    logger.warning(
                        "checkpoint %s: manifest names missing file %s",
                        gen_dir, rel,
                    )
                    return False
            return True
        except (OSError, ValueError, KeyError) as e:
            logger.warning("checkpoint %s: unreadable manifest: %s",
                           gen_dir, e)
            return False

    def complete_generations(self) -> list[int]:
        """Ascending list of on-disk generations with a valid manifest."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            m = _GEN_RE.match(name)
            if m and self._manifest_ok(os.path.join(self.root, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def current(self) -> tuple[int, str] | None:
        """(generation, dir) to load: CURRENT if valid, else the newest
        complete generation on disk, else None."""
        cur_path = os.path.join(self.root, "CURRENT.json")
        try:
            with open(cur_path) as f:
                gen = int(json.load(f)["generation"])
            gen_dir = self.gen_dir(gen)
            if self._manifest_ok(gen_dir):
                return gen, gen_dir
            logger.warning(
                "CURRENT generation %d is damaged; scanning for the "
                "newest complete generation", gen,
            )
        except (OSError, ValueError, KeyError, TypeError):
            # TypeError: valid JSON of the wrong shape (e.g. a list, or
            # {"generation": null}) — out-of-band damage must fall back
            # to the newest complete generation, not crash startup
            pass
        gens = self.complete_generations()
        if gens:
            return gens[-1], self.gen_dir(gens[-1])
        return None

    def stage(self, gen: int) -> str:
        """Fresh staging directory for generation ``gen``."""
        stage = self.gen_dir(gen) + ".tmp"
        if os.path.exists(stage):
            shutil.rmtree(stage)
        os.makedirs(stage)
        return stage

    def commit(self, gen: int, stage: str) -> str:
        """Manifest + fsync + rename + CURRENT + GC; returns the final
        generation directory."""
        files = []
        for dirpath, _dirnames, filenames in os.walk(stage):
            for name in filenames:
                full = os.path.join(dirpath, name)
                files.append(os.path.relpath(full, stage))
                if self.fsync:
                    fsync_file(full)
        _hook("pre_manifest")
        man = os.path.join(stage, "MANIFEST.json")
        with open(man, "w") as f:
            json.dump({"generation": gen, "files": sorted(files)}, f)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        if self.fsync:
            for dirpath, _d, _f in os.walk(stage):
                fsync_dir(dirpath)
        final = self.gen_dir(gen)
        if os.path.exists(final):  # leftover unreferenced generation
            shutil.rmtree(final)
        _hook("pre_rename")
        os.rename(stage, final)
        if self.fsync:
            fsync_dir(self.root)
        _hook("post_rename")
        atomic_write_json(
            os.path.join(self.root, "CURRENT.json"), {"generation": gen},
            fsync=self.fsync,
        )
        _hook("post_current")
        self._gc(keep=gen)
        return final

    def _gc(self, keep: int) -> None:
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for name in names:
            m = _GEN_RE.match(name.removesuffix(".tmp"))
            if name.endswith(".tmp") or (m and int(m.group(1)) != keep):
                path = os.path.join(self.root, name)
                try:
                    if os.path.isdir(path):
                        shutil.rmtree(path)
                    else:
                        os.remove(path)
                except OSError as e:
                    logger.warning("checkpoint GC of %s failed: %s", name, e)
