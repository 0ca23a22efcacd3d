"""Job API + supervisor actor.

Reference: `dashboard/modules/job/job_manager.py` — the supervisor actor
(`JobSupervisor`) runs the entrypoint as a subprocess; the manager layer
here is a thin module API over the controller KV (status/metadata) and
the supervisor (logs/stop), the same split as the reference's
JobInfoStorageClient over the GCS KV.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.core.runtime import get_runtime


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


_KV_PREFIX = "job:"


def _kv_write(job_id: str, info: Dict[str, Any]):
    get_runtime().kv_put(_KV_PREFIX + job_id, json.dumps(info).encode())


def _kv_read(job_id: str) -> Optional[Dict[str, Any]]:
    raw = get_runtime().kv_get(_KV_PREFIX + job_id)
    return json.loads(raw) if raw else None


class JobSupervisor:
    """One per job (reference: `job_manager.py` JobSupervisor actor).
    Runs the entrypoint in a process group so stop() can kill the whole
    tree; output streams to a log file as it is produced."""

    def __init__(self, job_id: str, entrypoint: str, log_path: str,
                 env: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None):
        self._job_id = job_id
        self._entrypoint = entrypoint
        self._log_path = log_path
        self._env = env or {}
        self._cwd = working_dir
        self._proc: Optional[subprocess.Popen] = None
        self._stopped = False

    def run(self) -> str:
        """Blocking execution; returns the terminal status.  Any setup
        failure lands in the KV as FAILED — a job must never be stuck
        PENDING with no diagnostic."""
        try:
            return self._run()
        except BaseException as e:  # noqa: BLE001 — terminal status sink
            info = _kv_read(self._job_id) or {}
            info.update(status=JobStatus.FAILED, end_time=time.time(),
                        error=repr(e))
            _kv_write(self._job_id, info)
            raise
        finally:
            self._schedule_self_cleanup()

    def _run(self) -> str:
        if self._stopped:  # stop landed before the process spawned
            info = _kv_read(self._job_id) or {}
            info.update(status=JobStatus.STOPPED, end_time=time.time())
            _kv_write(self._job_id, info)
            return JobStatus.STOPPED
        info = _kv_read(self._job_id) or {}
        info.update(status=JobStatus.RUNNING, start_time=time.time())
        _kv_write(self._job_id, info)
        env = dict(os.environ)
        env.update(self._env)
        os.makedirs(os.path.dirname(self._log_path), exist_ok=True)
        with open(self._log_path, "wb") as logf:
            self._proc = subprocess.Popen(
                self._entrypoint,
                shell=True,
                stdout=logf,
                stderr=subprocess.STDOUT,
                env=env,
                cwd=self._cwd,
                start_new_session=True,  # own process group for stop()
            )
            if self._stopped:  # stop raced the spawn: kill what we made
                self.stop()
            rc = self._proc.wait()
        if self._stopped:
            status = JobStatus.STOPPED
        elif rc == 0:
            status = JobStatus.SUCCEEDED
        else:
            status = JobStatus.FAILED
        info = _kv_read(self._job_id) or {}
        info.update(status=status, end_time=time.time(), returncode=rc)
        _kv_write(self._job_id, info)
        return status

    def _schedule_self_cleanup(self):
        """Supervisors self-terminate after a linger window (long
        enough to serve logs) instead of leaking one actor per job."""
        import threading

        linger = float(os.environ.get("RTT_JOB_SUPERVISOR_LINGER_S", "300"))

        def _die():
            try:
                rt_ = get_runtime()
                rt_.controller_call(
                    "kill_actor",
                    {"actor_id": rt_.actor_id.binary(), "no_restart": True},
                )
            except Exception:
                pass

        threading.Timer(linger, _die).start()

    def stop(self) -> bool:
        self._stopped = True
        if self._proc is not None and self._proc.poll() is None:
            try:
                os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
            except ProcessLookupError:
                pass
            deadline = time.time() + 5
            while self._proc.poll() is None and time.time() < deadline:
                time.sleep(0.1)
            if self._proc.poll() is None:
                try:
                    os.killpg(os.getpgid(self._proc.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
        return True

    def tail(self, nbytes: int = 65536) -> bytes:
        try:
            with open(self._log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - nbytes))
                return f.read()
        except OSError:
            return b""

    def read_from(self, offset: int, nbytes: int = 65536):
        """Incremental read for `rt job logs -f` (reference: the job
        SDK's tail_job_logs streaming).  Returns (chunk, new_offset)."""
        try:
            with open(self._log_path, "rb") as f:
                f.seek(offset)
                data = f.read(nbytes)
                return data, offset + len(data)
        except OSError:
            return b"", offset

    def ping(self) -> bool:
        return True


def _jobs_dir() -> str:
    base = os.environ.get("RTT_TMPDIR", os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))
    d = os.path.join(base, "jobs")
    os.makedirs(d, exist_ok=True)
    return d


def submit_job(entrypoint: str, *, submission_id: Optional[str] = None,
               env: Optional[Dict[str, str]] = None,
               working_dir: Optional[str] = None,
               metadata: Optional[Dict[str, str]] = None) -> str:
    """Launch an entrypoint under a supervisor actor; returns the job id
    (reference: `job_manager.py:421` submit_job)."""
    job_id = submission_id or f"job_{uuid.uuid4().hex[:10]}"
    if _kv_read(job_id) is not None:
        raise ValueError(f"job {job_id!r} already exists")
    log_path = os.path.join(_jobs_dir(), f"{job_id}.log")
    _kv_write(job_id, {
        "job_id": job_id,
        "entrypoint": entrypoint,
        "status": JobStatus.PENDING,
        "submit_time": time.time(),
        "log_path": log_path,
        "metadata": metadata or {},
    })
    supervisor = (
        rt.remote(JobSupervisor)
        .options(name=f"_job_supervisor:{job_id}", max_concurrency=4,
                 num_cpus=0)
        .remote(job_id, entrypoint, log_path, env=env,
                working_dir=working_dir)
    )
    supervisor.run.remote()  # fire and track via KV
    return job_id


def get_job_info(job_id: str) -> Dict[str, Any]:
    info = _kv_read(job_id)
    if info is None:
        raise ValueError(f"no job {job_id!r}")
    return info


def get_job_status(job_id: str) -> str:
    return get_job_info(job_id)["status"]


def get_job_logs(job_id: str) -> str:
    info = get_job_info(job_id)
    try:
        sup = rt.get_actor(f"_job_supervisor:{job_id}")
        return rt.get(sup.tail.remote(), timeout=10).decode(
            "utf-8", errors="replace"
        )
    except Exception:
        # supervisor gone (past its linger window): read the file —
        # valid on the node that hosted it; elsewhere, be loud rather
        # than silently empty
        try:
            with open(info["log_path"], "rb") as f:
                return f.read().decode("utf-8", errors="replace")
        except OSError as e:
            raise RuntimeError(
                f"logs for {job_id!r} are no longer reachable (supervisor "
                f"exited; {info['log_path']} not on this node)"
            ) from e


def follow_job_logs(job_id: str, poll_s: float = 0.5):
    """Generator yielding log chunks (str) until the job reaches a
    terminal status and the log is drained — `rt job logs -f`
    (reference: JobSubmissionClient.tail_job_logs)."""
    get_job_info(job_id)
    try:
        sup = rt.get_actor(f"_job_supervisor:{job_id}")
    except Exception:
        # supervisor past its linger window: everything the job printed
        # is already on disk — same fallback as the non-follow path
        yield get_job_logs(job_id)
        return
    offset = 0

    def _file_tail_from(off: int) -> str:
        # supervisor expired mid-stream (linger timer): the log file has
        # the rest — valid on the node that hosted it
        try:
            info = get_job_info(job_id)
            with open(info["log_path"], "rb") as f:
                f.seek(off)
                return f.read().decode("utf-8", errors="replace")
        except Exception:
            return ""

    while True:
        try:
            chunk, offset = rt.get(sup.read_from.remote(offset), timeout=15)
        except Exception:
            rest = _file_tail_from(offset)
            if rest:
                yield rest
            return
        if chunk:
            yield chunk.decode("utf-8", errors="replace")
            continue  # drain fast while data is flowing
        status = get_job_status(job_id)
        if status in (JobStatus.SUCCEEDED, JobStatus.FAILED,
                      JobStatus.STOPPED):
            while True:  # drain the FULL tail, not one chunk
                try:
                    chunk, offset = rt.get(
                        sup.read_from.remote(offset), timeout=15
                    )
                except Exception:
                    rest = _file_tail_from(offset)
                    if rest:
                        yield rest
                    return
                if not chunk:
                    return
                yield chunk.decode("utf-8", errors="replace")
        time.sleep(poll_s)


def list_jobs() -> List[Dict[str, Any]]:
    rt_ = get_runtime()
    keys = rt_.controller_call("kv_keys", {"prefix": _KV_PREFIX})
    out = []
    for key in keys or []:
        raw = rt_.kv_get(key)
        if raw:
            out.append(json.loads(raw))
    return sorted(out, key=lambda j: j.get("submit_time", 0))


def stop_job(job_id: str) -> bool:
    get_job_info(job_id)
    try:
        sup = rt.get_actor(f"_job_supervisor:{job_id}")
        return rt.get(sup.stop.remote(), timeout=15)
    except ValueError:
        return False


def wait_job(job_id: str, timeout: float = 300.0) -> str:
    """Block until the job reaches a terminal status."""
    deadline = time.time() + timeout
    status = get_job_status(job_id)
    while time.time() < deadline:
        status = get_job_status(job_id)
        if status in JobStatus.TERMINAL:
            return status
        time.sleep(0.2)
    raise TimeoutError(f"job {job_id!r} still {status} after {timeout}s")
