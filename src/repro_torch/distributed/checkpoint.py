"""Checkpoints of any tree of tensors and their content-hash manifests;
port of ``repro.distributed.checkpoint`` (that module imports JAX).

:func:`save_checkpoint`, :func:`restore_checkpoint`, :func:`latest_step`
and :func:`load_metadata` are :mod:`repro_torch.checkpoint`'s: atomic
``step_<k>.npz`` + JSON sidecar in the reference's format and leaf order,
so a tree saved by either package restores in the other. The port runs as
one process, which writes every checkpoint itself.

A manifest lists the files one checkpoint consists of (the ``.npz`` payload
and its JSON sidecar) with size and sha256, so a reader in another process
can verify it fetched exactly what the writer published. The format is the
reference's, so a manifest written by either package verifies in the other.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

from repro_torch.checkpoint import (
    latest_step,
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_metadata", "file_sha256", "checkpoint_manifest",
           "verify_manifest"]


def file_sha256(path: str, chunk_bytes: int = 1 << 20) -> str:
    """Streaming sha256 of a file (content-addressing for artifact stores)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while block := f.read(chunk_bytes):
            h.update(block)
    return h.hexdigest()


def checkpoint_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """Content-hash manifest of one checkpoint (default: latest).

    Torn copies, partial rsyncs and bit rot then fail loudly at
    :func:`verify_manifest` instead of deserialising garbage into a served
    model.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    files = {}
    for suffix in (".npz", ".json"):
        name = f"step_{step}{suffix}"
        path = os.path.join(ckpt_dir, name)
        files[name] = {
            "sha256": file_sha256(path),
            "bytes": os.path.getsize(path),
        }
    return {"step": int(step), "files": files}


def verify_manifest(ckpt_dir: str, manifest: dict) -> None:
    """Raise ValueError if any manifest-listed file is missing or corrupt."""
    for name, want in manifest["files"].items():
        path = os.path.join(ckpt_dir, name)
        if not os.path.exists(path):
            raise ValueError(f"manifest file missing: {path}")
        got = file_sha256(path)
        if got != want["sha256"]:
            raise ValueError(
                f"content hash mismatch for {path}: "
                f"manifest {want['sha256'][:12]}.., file {got[:12]}.."
            )
