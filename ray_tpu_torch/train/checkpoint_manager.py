"""Checkpoint retention + atomic commit.

Top-K retention follows the reference
(`train/_internal/checkpoint_manager.py`).  The commit path is the
elastic-training primitive on top: a checkpoint becomes "latest" only
via an atomic rename of a fully-staged directory carrying a per-file
checksum manifest, so a worker preempted mid-save (or a driver killed
mid-copy) can never leave a half-written directory the restore path
will trust.  `validate_checkpoint` re-verifies the manifest on restore
and the trainer's recovery path walks `latest_valid` — corrupted or
partial checkpoints are skipped, not loaded.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import uuid
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    _new_checkpoint_dirname,
    merge_into,
)
from ray_tpu_torch.train.config import CheckpointConfig

logger = logging.getLogger(__name__)

_COMMIT_MANIFEST = "commit_manifest.json"
_STAGING_PREFIX = ".tmp_checkpoint_"
_RETIRED_PREFIX = ".retired_checkpoint_"


class CheckpointCommitError(RuntimeError):
    """The staged checkpoint would not pass its own restore
    validation (e.g. a partial round merged fewer writer ranks than
    the sharded manifest promises) — it was NOT published and the
    previous checkpoint remains `latest`."""


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _walk_files(dir_: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(dir_):
        for fn in files:
            out.append(os.path.relpath(os.path.join(root, fn), dir_))
    return sorted(out)


def write_commit_manifest(dir_: str, index: int) -> None:
    """Record every staged file's size + crc32, fsync'd, as the last
    write before the publishing rename."""
    files: Dict[str, Dict[str, Optional[int]]] = {}
    for rel in _walk_files(dir_):
        if rel == _COMMIT_MANIFEST:
            continue
        p = os.path.join(dir_, rel)
        # piece archives whose sharded index records per-piece crc32s
        # are covered byte-for-byte by load_sharded's read-time
        # verification: recording crc32=None skips re-reading multi-GB
        # params on EVERY per-step commit (size is still recorded and
        # checked; every other file gets the full CRC)
        if (os.path.basename(rel).startswith("pieces_r")
                and rel.endswith(".npz")
                and _piece_crcs_recorded(dir_, rel)):
            crc: Optional[int] = None
        else:
            crc = _file_crc32(p)
        files[rel] = {"size": os.path.getsize(p), "crc32": crc}
    manifest = {"version": 1, "index": index, "files": files}
    path = os.path.join(dir_, _COMMIT_MANIFEST)
    with open(path, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def _piece_crcs_recorded(dir_: str, npz_rel: str) -> bool:
    """True when the sharded index alongside `pieces_rNNNNN.npz`
    records a per-piece crc32 for every piece — i.e. `load_sharded`
    will itself verify these bytes at read time."""
    idx = os.path.join(dir_, npz_rel[:-len(".npz")] + ".json")
    try:
        with open(idx) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return False
    return bool(entries) and all(
        e.get("crc32") is not None for e in entries
    )


def validate_checkpoint(path: str, fast: bool = False) -> Tuple[bool, str]:
    """Is `path` a complete, uncorrupted committed checkpoint?

    - no commit manifest → LEGACY-valid (user-supplied
      `resume_from_checkpoint` directories predate the commit
      protocol) as long as the directory exists and is non-empty;
    - with a manifest, every listed file must exist with matching size
      and crc32;
    - a sharded checkpoint must additionally carry the piece index of
      EVERY writer rank its own manifest promises — a merge that lost
      a rank's pieces assembles garbage and is rejected here instead
      of at `load_sharded`'s partial-coverage error deep in the loop.

    With ``fast=True`` (the restore hot path), piece archives whose
    sharded index records per-piece checksums skip the whole-file CRC
    — `load_sharded` verifies exactly those bytes at read time, so the
    recovery window reads multi-GB params once, not twice.  Existence
    and size are always checked; all other files always get the full
    CRC."""
    if not os.path.isdir(path):
        return False, "not a directory"
    mpath = os.path.join(path, _COMMIT_MANIFEST)
    if not os.path.exists(mpath):
        if not os.listdir(path):
            return False, "empty checkpoint directory"
        return True, "legacy (no commit manifest)"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable commit manifest: {e}"
    for rel, meta in manifest.get("files", {}).items():
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            return False, f"missing file {rel}"
        if os.path.getsize(p) != meta.get("size"):
            return False, f"size mismatch for {rel}"
        if meta.get("crc32") is None:
            # recorded as piece-CRC-covered at commit time: integrity
            # of these bytes is verified by load_sharded on read
            continue
        if (fast and os.path.basename(rel).startswith("pieces_r")
                and rel.endswith(".npz")
                and _piece_crcs_recorded(path, rel)):
            continue
        try:
            if _file_crc32(p) != meta.get("crc32"):
                return False, f"checksum mismatch for {rel}"
        except OSError as e:
            return False, f"unreadable file {rel}: {e}"
    sharded = os.path.join(path, "sharded_manifest.json")
    if os.path.exists(sharded):
        try:
            with open(sharded) as f:
                n = int(json.load(f).get("num_processes", 1))
        except (OSError, ValueError) as e:
            return False, f"unreadable sharded manifest: {e}"
        for r in range(n):
            if not os.path.exists(
                os.path.join(path, f"pieces_r{r:05d}.json")
            ):
                return False, f"missing sharded pieces for rank {r}/{n}"
    return True, "ok"


def sweep_staging(run_dir: str) -> int:
    """Remove orphaned staging/retired directories (a driver killed
    mid-commit leaves `.tmp_checkpoint_*` / `.retired_checkpoint_*`
    behind; neither is ever a published checkpoint and they must not
    accumulate).  Returns the number swept."""
    n = 0
    try:
        entries = os.listdir(run_dir)
    except OSError:
        return 0
    for entry in entries:
        if entry.startswith((_STAGING_PREFIX, _RETIRED_PREFIX)):
            shutil.rmtree(os.path.join(run_dir, entry), ignore_errors=True)
            n += 1
    return n


@dataclass
class _TrackedCheckpoint:
    checkpoint: Checkpoint
    metrics: Dict[str, Any]
    index: int


class CheckpointManager:
    def __init__(self, config: Optional[CheckpointConfig] = None):
        self.config = config or CheckpointConfig()
        self._checkpoints: List[_TrackedCheckpoint] = []

    def commit(
        self,
        reported: List[Checkpoint],
        run_dir: str,
        index: int,
        metrics: Dict[str, Any],
    ) -> Checkpoint:
        """Atomic publish of one training iteration's checkpoint: merge
        every reporting rank into a staging directory, stamp metadata,
        write the per-file checksum manifest (fsync'd), then rename
        into place.  Readers either see the previous checkpoint or the
        complete new one — never a partial merge."""
        staging = os.path.join(
            run_dir, f"{_STAGING_PREFIX}{index:06d}_{uuid.uuid4().hex[:8]}"
        )
        final = os.path.join(run_dir, _new_checkpoint_dirname(index))
        retired = None
        try:
            for ck in reported:
                merge_into(ck, staging)
            staged = Checkpoint(staging)
            staged.update_metadata({"iteration": index})
            write_commit_manifest(staging, index)
            ok, why = validate_checkpoint(staging, fast=True)
            if not ok:
                # a commit that its own restore validation rejects
                # (e.g. a stop-boundary round merged fewer writer
                # ranks than the sharded manifest promises) must
                # never be published — and must never trigger the
                # retention sweep that could evict the last GOOD one
                raise CheckpointCommitError(why)
            if os.path.exists(final):
                # an index collision (a run_dir reused across fit()
                # calls) supersedes the old commit — but the old data
                # must never be DESTROYED before the replacement is
                # published: rename it aside (crash-safe), reap after
                retired = os.path.join(
                    run_dir,
                    f"{_RETIRED_PREFIX}{index:06d}_{uuid.uuid4().hex[:8]}",
                )
                os.rename(final, retired)
            os.rename(staging, final)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            if retired is not None and not os.path.exists(final):
                # publishing failed after the aside-rename: put the
                # old commit back so "latest" still exists on disk
                try:
                    os.rename(retired, final)
                    retired = None
                except OSError as e:
                    logger.warning(
                        "could not restore retired checkpoint %s: %s",
                        retired, e,
                    )
            raise
        if retired is not None:
            shutil.rmtree(retired, ignore_errors=True)
        _fsync_dir(run_dir)
        persisted = Checkpoint(final)
        self.register(persisted, metrics, index)
        return persisted

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any],
                 index: int) -> None:
        self._checkpoints = [
            c for c in self._checkpoints if c.checkpoint != checkpoint
        ]
        self._checkpoints.append(_TrackedCheckpoint(checkpoint, metrics, index))
        k = self.config.num_to_keep
        if k is None or len(self._checkpoints) <= k:
            return
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            evict = self._checkpoints.pop(0)  # oldest
        else:
            sign = 1 if self.config.checkpoint_score_order == "max" else -1
            worst = min(
                (c for c in self._checkpoints[:-1]),  # never evict the newest
                key=lambda c: sign * float(c.metrics.get(attr, float("-inf") * sign)),
                default=None,
            )
            if worst is None:
                return
            self._checkpoints.remove(worst)
            evict = worst
        shutil.rmtree(evict.checkpoint.path, ignore_errors=True)

    @property
    def latest(self) -> Optional[Checkpoint]:
        if not self._checkpoints:
            return None
        return max(self._checkpoints, key=lambda c: c.index).checkpoint

    @property
    def latest_valid(self) -> Optional[Checkpoint]:
        """Newest tracked checkpoint that passes commit-manifest
        validation — the elastic restore entry point.  Corrupted or
        partial directories are logged and skipped, never loaded."""
        for tracked in sorted(
            self._checkpoints, key=lambda c: c.index, reverse=True
        ):
            path = tracked.checkpoint.path
            # fast=True: piece files (the multi-GB bulk) skip the
            # whole-file CRC here because load_sharded verifies their
            # per-piece checksums at read time anyway — the restore
            # window pays one read of the bytes, not two
            ok, why = validate_checkpoint(path, fast=True)
            if ok:
                return tracked.checkpoint
            logger.warning(
                "skipping checkpoint %s for restore: %s", path, why,
            )
        return None

    @property
    def best(self) -> Optional[Checkpoint]:
        attr = self.config.checkpoint_score_attribute
        if not self._checkpoints:
            return None
        if attr is None:
            return self.latest
        sign = 1 if self.config.checkpoint_score_order == "max" else -1
        return max(
            self._checkpoints,
            key=lambda c: sign * float(c.metrics.get(attr, float("-inf") * sign)),
        ).checkpoint

    @property
    def best_checkpoints(self) -> List[tuple]:
        return [(c.checkpoint, c.metrics) for c in self._checkpoints]


def _fsync_dir(path: str) -> None:
    """Durably record a rename in its parent directory (best-effort on
    filesystems without directory fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError as e:
        logger.debug("cannot fsync dir %s: %s", path, e)
        return
    try:
        os.fsync(fd)
    except OSError as e:
        logger.debug("dir fsync failed for %s: %s", path, e)
    finally:
        os.close(fd)
