"""The port's job submission (`ray_tpu_torch.job`) on the CPU: the JAX
package's `tests/test_job.py` on the port's runtime, the REST case
through the port's dashboard.

One module-scoped cluster of the port's runtime serves every case.
Every wait carries its own limit (`wait_job`'s timeout, `within` for
the streamed logs).
"""

import json
import sys
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import job
from test_torch_waits import within


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_workers=2, num_cpus=8, ignore_reinit_error=True)
    yield
    rt.shutdown()


def _wait_running(jid, seconds=30.0):
    deadline = time.time() + seconds
    while job.get_job_status(jid) != job.JobStatus.RUNNING:
        assert time.time() < deadline, job.get_job_info(jid)
        time.sleep(0.1)


def test_submit_and_succeed(cluster):
    jid = job.submit_job(f"{sys.executable} -c \"print('hello from job')\"")
    status = job.wait_job(jid, timeout=60)
    assert status == job.JobStatus.SUCCEEDED
    assert "hello from job" in job.get_job_logs(jid)
    info = job.get_job_info(jid)
    assert info["returncode"] == 0
    assert any(j["job_id"] == jid for j in job.list_jobs())


def test_failing_job(cluster):
    jid = job.submit_job(f"{sys.executable} -c \"import sys; sys.exit(3)\"")
    assert job.wait_job(jid, timeout=60) == job.JobStatus.FAILED
    assert job.get_job_info(jid)["returncode"] == 3


def test_stop_job(cluster):
    jid = job.submit_job(f"{sys.executable} -c \"import time; time.sleep(60)\"")
    _wait_running(jid)
    assert job.stop_job(jid)
    assert job.wait_job(jid, timeout=30) == job.JobStatus.STOPPED


def test_job_env_and_metadata(cluster):
    jid = job.submit_job(
        f"{sys.executable} -c \"import os; print('V=' + os.environ['MYVAR'])\"",
        env={"MYVAR": "42"},
        metadata={"owner": "test"},
    )
    assert job.wait_job(jid, timeout=60) == job.JobStatus.SUCCEEDED
    assert "V=42" in job.get_job_logs(jid)
    assert job.get_job_info(jid)["metadata"]["owner"] == "test"


def test_follow_job_logs_streams_until_done(cluster):
    jid = job.submit_job(
        f"{sys.executable} -u -c \""
        "import time\n"
        "for i in range(5):\n"
        "    print('tick', i, flush=True)\n"
        "    time.sleep(0.3)\n"
        "print('done')\"",
    )
    chunks = within(90.0, lambda: list(job.follow_job_logs(jid, poll_s=0.2)))
    text = "".join(chunks)
    assert all(f"tick {i}" in text for i in range(5)), text
    assert "done" in text
    # follow streamed incrementally (more than one chunk) and the job
    # finished
    assert len(chunks) >= 2
    assert job.get_job_status(jid) == job.JobStatus.SUCCEEDED


def test_rest_job_submit_status_logs_stop(cluster):
    from ray_tpu_torch.dashboard import start_dashboard

    head, (host, port) = start_dashboard()
    base = f"http://{host}:{port}"
    try:
        body = json.dumps({
            "entrypoint": f"{sys.executable} -c \"print('rest job ran')\"",
            "metadata": {"owner": "resttest"},
        }).encode()
        req = urllib.request.Request(
            f"{base}/api/jobs", data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=15) as r:
            reply = json.loads(r.read())
        jid = reply["submission_id"]
        assert reply["job_id"] == jid
        assert job.wait_job(jid, timeout=60) == job.JobStatus.SUCCEEDED
        with urllib.request.urlopen(f"{base}/api/jobs/{jid}",
                                    timeout=10) as r:
            info = json.loads(r.read())
        assert info["status"] == job.JobStatus.SUCCEEDED
        assert info["metadata"] == {"owner": "resttest"}
        with urllib.request.urlopen(f"{base}/api/jobs/{jid}/logs",
                                    timeout=10) as r:
            assert b"rest job ran" in r.read()
        # bad submissions are 400s, an unknown job id a 404
        req = urllib.request.Request(
            f"{base}/api/jobs", data=b"{}", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/api/jobs/nope", timeout=10)
        assert e.value.code == 404
        # stop a long-running REST-submitted job
        body = json.dumps({
            "entrypoint": f"{sys.executable} -c \"import time; time.sleep(300)\"",
        }).encode()
        req = urllib.request.Request(
            f"{base}/api/jobs", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=15) as r:
            jid2 = json.loads(r.read())["job_id"]
        _wait_running(jid2)
        req = urllib.request.Request(
            f"{base}/api/jobs/{jid2}/stop", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=15) as r:
            assert json.loads(r.read())["stopped"] is True
        assert job.wait_job(jid2, timeout=30) == job.JobStatus.STOPPED
    finally:
        rt.kill(head)


def test_jobs_dir_is_the_ports_own(cluster, monkeypatch, tmp_path):
    """A job's log lands under the port's session base (`RTT_TMPDIR`),
    never under the JAX package's."""
    from ray_tpu_torch.job import api

    monkeypatch.delenv("RTT_TMPDIR", raising=False)
    assert "ray_tpu_torch" in api._jobs_dir().split("/")
    monkeypatch.setenv("RTT_TMPDIR", str(tmp_path))
    assert api._jobs_dir() == str(tmp_path / "jobs")
