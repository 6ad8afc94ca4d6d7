"""Versioned artifact distribution for `ServableGP` models; port of
``repro.serve.cluster.store``.

Layout (one directory per published version, plus an atomic pointer):

    store/
      v0000001/
        step_0.npz        # checkpoint payload (repro_torch.checkpoint)
        step_0.json       # checkpoint sidecar (shapes, kernel kind, ...)
        manifest.json     # content hashes + model name + publisher metadata
      v0000002/...
      LATEST              # text file naming the current version

Publish protocol: the version directory is assembled under a hidden temp
name and ``os.rename``d into place, THEN ``LATEST`` is swapped via
write-temp + rename. Readers that follow ``LATEST`` therefore never observe
a half-written version; the manifest's sha256 hashes additionally catch
torn copies when the store lives on a shared/remote filesystem. N replica
processes poll ``LATEST`` (see :class:`ArtifactPoller`) and swap the new
model into their engine — cross-process distribution with no coordination
service beyond a filesystem.

The layout, payload and manifest are the reference's, so a store published
by either package is fetched and verified by the other. A fetch loads the
artifact onto ``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Callable, Optional

from repro_torch.distributed.checkpoint import (
    checkpoint_manifest,
    verify_manifest,
)
from repro_torch.serve.artifact import ServableGP, load_servable, save_servable
from repro_torch.serve.multimodel import MultiModelServer

LATEST = "LATEST"
MANIFEST = "manifest.json"
_VERSION_FMT = "v{:07d}"


def _version_num(name: str) -> Optional[int]:
    if name.startswith("v") and name[1:].isdigit():
        return int(name[1:])
    return None


def list_versions(store_dir: str) -> list[str]:
    """All published version names, oldest first."""
    if not os.path.isdir(store_dir):
        return []
    names = [n for n in os.listdir(store_dir)
             if _version_num(n) is not None
             and os.path.isdir(os.path.join(store_dir, n))]
    return sorted(names, key=_version_num)


def latest_version(store_dir: str) -> Optional[str]:
    """The version named by the LATEST pointer (None before first publish)."""
    path = os.path.join(store_dir, LATEST)
    try:
        with open(path) as f:
            name = f.read().strip()
    except FileNotFoundError:
        return None
    return name or None


def read_manifest(store_dir: str, version: str) -> dict:
    """Load ``<store>/<version>/manifest.json`` (hashes, files, metadata)."""
    with open(os.path.join(store_dir, version, MANIFEST)) as f:
        return json.load(f)


def publish_servable(
    store_dir: str,
    model: ServableGP,
    name: str = "default",
    extra_metadata: Optional[dict] = None,
) -> str:
    """Publish ``model`` as the next version; returns the version name.

    The write is atomic at two levels: the version directory appears fully
    formed (temp dir + rename), and ``LATEST`` flips in one rename after
    the directory exists. Concurrent publishers are serialised by the
    rename: the loser's temp rename fails and is retried on the next
    version number.
    """
    os.makedirs(store_dir, exist_ok=True)
    versions = list_versions(store_dir)
    next_num = (_version_num(versions[-1]) + 1) if versions else 1
    while True:
        version = _VERSION_FMT.format(next_num)
        final = os.path.join(store_dir, version)
        tmp = os.path.join(store_dir, f".tmp-{version}-{os.getpid()}")
        os.makedirs(tmp)
        save_servable(tmp, model, step=0, keep=1)
        manifest = checkpoint_manifest(tmp, step=0)
        manifest.update({
            "version": version,
            "artifact": "ServableGP",
            "name": name,
            "published_unix": time.time(),
        })
        manifest.update(extra_metadata or {})
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.rename(tmp, final)
        except OSError:
            # A concurrent publisher claimed this version; retry the next.
            shutil.rmtree(tmp, ignore_errors=True)
            next_num += 1
            continue
        break

    _advance_latest(store_dir, version)
    return version


def _advance_latest(store_dir: str, version: str) -> None:
    """Advance LATEST to the newest published version (>= ``version``).

    Racing publishers flip the pointer in arbitrary order, so flipping to
    one's OWN version could clobber a newer one. Instead every publisher
    loops re-reading the directory listing (version dirs appear atomically
    via rename) and re-flipping until the pointer names the current
    maximum — the unique stable outcome, never a stale pointer.
    """
    while True:
        target = list_versions(store_dir)[-1]  # >= version; dirs are atomic
        if latest_version(store_dir) == target:
            return
        ptr_tmp = os.path.join(store_dir, f".tmp-{LATEST}-{os.getpid()}")
        with open(ptr_tmp, "w") as f:
            f.write(target + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.rename(ptr_tmp, os.path.join(store_dir, LATEST))


def fetch_servable(
    store_dir: str,
    version: Optional[str] = None,
    verify: bool = True,
    device="cuda",
) -> tuple[ServableGP, str, dict]:
    """Load (model, version, manifest) onto ``device``; default: whatever
    LATEST names.

    ``verify=True`` re-hashes the payload against the manifest before
    deserialising — a corrupt or torn artifact raises instead of serving
    garbage predictions.
    """
    if version is None:
        version = latest_version(store_dir)
        if version is None:
            raise FileNotFoundError(f"no published versions under {store_dir}")
    vdir = os.path.join(store_dir, version)
    manifest = read_manifest(store_dir, version)
    if verify:
        verify_manifest(vdir, manifest)
    model = load_servable(vdir, step=manifest.get("step", 0), device=device)
    return model, version, manifest


class ArtifactPoller:
    """Poll LATEST and swap new versions into an engine (one per replica).

    ``target`` is a `BucketedEngine` (swap via ``swap_model``) or a
    `MultiModelServer` (swap/register by the manifest's model ``name``);
    each version is fetched onto ``device``. A failed fetch (torn copy,
    transient FS error) leaves the currently served version untouched and
    is retried on the next tick.
    """

    def __init__(
        self,
        store_dir: str,
        target,
        interval_s: float = 2.0,
        warmup: bool = True,
        on_swap: Optional[Callable[[str, dict], None]] = None,
        device="cuda",
    ):
        self.store_dir = store_dir
        self.device = device
        self.target = target
        self.interval_s = float(interval_s)
        self.warmup = warmup
        self.on_swap = on_swap
        # Poll state is written by the daemon thread and read by the
        # replica main thread (/stats, startup error reporting) — all
        # access goes through self._lock; external readers use status().
        self._lock = threading.Lock()
        self.version: Optional[str] = None  #: guarded by self._lock
        self.last_error: Optional[str] = None  #: guarded by self._lock
        self.swaps = 0  #: guarded by self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _swap_into_target(self, model: ServableGP, name: str) -> None:
        if isinstance(self.target, MultiModelServer):
            if self.warmup:
                self.target.engine.warmup(model)
            if name in self.target.names():
                self.target.swap(name, model)
            else:
                self.target.register(name, model)
        else:
            if self.warmup:
                self.target.warmup(model)
            self.target.swap_model(model)

    def status(self) -> dict:
        """Consistent snapshot of the poll state (thread-safe)."""
        with self._lock:
            return {"version": self.version, "swaps": self.swaps,
                    "last_error": self.last_error}

    def poll_once(self) -> bool:
        """Check LATEST; fetch + swap if it moved. Returns True on a swap.

        The fetch + warmup + swap runs outside the lock (it does file IO
        and a warm-up dispatch per bucket); only the published poll state is guarded.
        Called from the daemon thread and, for the initial fetch, from the
        replica main thread before the thread starts — never concurrently
        with itself.
        """
        try:
            version = latest_version(self.store_dir)
            with self._lock:
                current = self.version
            if version is None or version == current:
                return False
            model, version, manifest = fetch_servable(
                self.store_dir, version, device=self.device)
            self._swap_into_target(model, manifest.get("name", "default"))
            with self._lock:
                self.version = version
                self.swaps += 1
                self.last_error = None
            if self.on_swap is not None:
                self.on_swap(version, manifest)
            return True
        except Exception as e:  # keep serving the old version
            with self._lock:
                self.last_error = f"{type(e).__name__}: {e}"
            return False

    def start(self) -> None:
        """Begin polling LATEST on a daemon thread (no-op if running)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                self.poll_once()

        self._thread = threading.Thread(
            target=_loop, name="artifact-poller", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the polling thread (joins with a timeout; idempotent)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
