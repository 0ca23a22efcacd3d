"""Checkpoint: a directory-of-files abstraction.

Reference: `train/_checkpoint.py` — a Checkpoint is a handle to a
directory (local path here; the reference adds pyarrow-fs URIs), with
`from_directory` / `to_directory` / `as_directory` and a metadata
sidecar.  Orbax/flax serialization composes on top: callers write arrays
into the directory however they like (`orbax`, `np.savez`, msgpack).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import uuid
from typing import Any, Dict, Iterator, Optional

_METADATA_FILE = ".metadata.json"


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._temp_source = False

    # -- constructors --------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        """Convenience for small state dicts (numpy-picklable)."""
        import pickle

        d = tempfile.mkdtemp(prefix="rt_ckpt_")
        with open(os.path.join(d, "state.pkl"), "wb") as f:
            pickle.dump(data, f)
        ck = cls(d)
        ck._temp_source = True  # persist_checkpoint may reclaim the dir
        return ck

    def to_dict(self) -> Dict[str, Any]:
        from ray_tpu_torch.core import serialization

        with open(os.path.join(self.path, "state.pkl"), "rb") as f:
            return serialization.loads(f.read())

    # -- directory access ----------------------------------------------
    def to_directory(self, path: Optional[str] = None) -> str:
        """Copy checkpoint contents into `path` (or a temp dir)."""
        dest = path or tempfile.mkdtemp(prefix="rt_ckpt_")
        os.makedirs(dest, exist_ok=True)
        for entry in os.listdir(self.path):
            src = os.path.join(self.path, entry)
            dst = os.path.join(dest, entry)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        return dest

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        """Zero-copy when local: yields the backing directory."""
        yield self.path

    # -- metadata ------------------------------------------------------
    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METADATA_FILE)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        m = self.get_metadata()
        m.update(metadata)
        self.set_metadata(m)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"

    def __eq__(self, other):
        return isinstance(other, Checkpoint) and other.path == self.path


def _new_checkpoint_dirname(index: int) -> str:
    return f"checkpoint_{index:06d}"


def merge_into(checkpoint: Checkpoint, dest: str) -> str:
    """Merge one reported checkpoint's contents into `dest` (all
    reporting ranks land in the same directory — under DP every rank
    holds the same state; under model parallelism ranks write
    distinctly-named shard files).  Reclaims temp-sourced checkpoint
    directories after the copy."""
    os.makedirs(dest, exist_ok=True)
    checkpoint.to_directory(dest)
    if getattr(checkpoint, "_temp_source", False):
        shutil.rmtree(checkpoint.path, ignore_errors=True)
    return dest


def persist_checkpoint(checkpoint: Checkpoint, run_dir: str, index: int) -> str:
    """Copy a worker-local checkpoint into run storage (NON-atomic: the
    destination is visible while being written).  The trainer's fit
    loop uses `CheckpointManager.commit` instead, which stages all
    reporting ranks in a temp directory, records a per-file checksum
    manifest, and renames — a half-written "latest" is never trusted by
    the restore path.  Reference: `train/_internal/storage.py`
    persist_current_checkpoint."""
    return merge_into(
        checkpoint, os.path.join(run_dir, _new_checkpoint_dirname(index))
    )
