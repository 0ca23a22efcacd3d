"""Sanitizer pass over the port's C++ shm store: the JAX package's
`tests/test_sanitizers.py` on `ray_tpu_torch/shm/run_sanitizers.sh`,
which builds the port's `shm/shmstore.cc` with the stress harness in
one translation unit under TSAN, ASAN+UBSAN and UBSAN and fails on any
report.  The harness's segment is named after its process
(`/rtts_sanitizer_stress_<pid>`) and its build directory lies under
`$TMPDIR`, so passes from two checkouts, or the JAX package's beside
this one, may run at once; this case builds under its own temp dir."""

import os
import shutil
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_shmstore_under_sanitizers(tmp_path):
    script = REPO / "ray_tpu_torch" / "shm" / "run_sanitizers.sh"
    proc = subprocess.run(
        ["bash", str(script)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "TMPDIR": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "sanitizers clean" in proc.stdout
    # all three passes actually ran, each over the whole stress load
    for pass_marker in ("== TSAN ==", "== ASAN+UBSAN ==", "== UBSAN =="):
        assert pass_marker in proc.stdout, proc.stdout
    assert proc.stdout.count("shmstore stress OK") == 3, proc.stdout
    assert sorted(p.name for p in (tmp_path / "rtts_sanitizers").iterdir()
                  ) == ["stress_asan", "stress_tsan", "stress_ubsan"]
    # sanity: a sanitizer report would have printed WARNING/ERROR
    assert "WARNING: ThreadSanitizer" not in proc.stdout + proc.stderr
    assert "ERROR: AddressSanitizer" not in proc.stdout + proc.stderr
    # UBSAN reports print "runtime error:" (and the standalone pass
    # traps via -fno-sanitize-recover, failing the returncode assert)
    assert "runtime error:" not in proc.stdout + proc.stderr
    # two harness processes at once: each stresses a segment of its own
    runs = [subprocess.Popen([str(tmp_path / "rtts_sanitizers" /
                                  "stress_ubsan")],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for _ in range(2)]
    for run in runs:
        out, err = run.communicate(timeout=300)
        assert run.returncode == 0 and "shmstore stress OK" in out, (
            out + err)


def test_harness_builds_the_ports_store():
    """The stress harness includes the port's store source beside it and
    no other, and names its segment after its process; outside that name
    it is the JAX package's harness after the namespace rewrite."""
    from test_torch_copies import rewrite

    rel = "shm/shmstore_stress.cc"
    src = (REPO / "ray_tpu_torch" / rel).read_text()
    includes = [line for line in src.splitlines()
                if line.startswith("#include \"")]
    assert includes == ['#include "shmstore.cc"  // single-TU build: '
                        'sanitize the real code']
    named = ('  // a segment of this process\'s own: passes from two '
             'checkouts, or the\n'
             '  // JAX package\'s beside this one, may run at once\n'
             '  char name[64];\n'
             '  std::snprintf(name, sizeof(name), '
             '"/rtts_sanitizer_stress_%d",\n'
             '                (int)getpid());\n')
    assert src.count(named) == 1
    ref = (REPO / "ray_tpu" / rel).read_text()
    assert ref.count('  const char* name = "/rts_sanitizer_stress";\n') == 1
    port = src.replace(named, '  const char* name = '
                              '"/rtts_sanitizer_stress";\n')
    port = port.replace("#include <vector>\n\n#include <unistd.h>\n",
                        "#include <vector>\n")
    assert port == rewrite(ref, rel)
