"""rtlint: AST-based invariant checks for the ray_tpu_torch runtime.

The C++ shm store is guarded by TSAN/ASAN/UBSAN (`shm/run_sanitizers.sh`,
reference practice per SURVEY §5.2), but the Python runtime has no
equivalent: its concurrency, wire-safety, and fault-tolerance contracts
(no pickle on the control path, deadline propagation, breaker-fed RPC,
jittered retries) were enforced only by reviewer memory.  rtlint encodes
them as small AST checks so tier-1 fails when they rot.

Usage:
    python -m ray_tpu_torch.lint [paths...]          # check against baseline
    python -m ray_tpu_torch.lint --write-baseline    # regenerate the baseline

Findings on the port's checked-in `ray_tpu_torch/lint/lint_baseline.json`
(the JAX package's root `lint_baseline.json` is that tree's own) are
grandfathered by (path, rule) count: CI fails only on NEW violations,
and a grandfathered count can only shrink.  Inline suppression:

    do_thing()  # rtlint: disable=RT001
    # rtlint: disable-file=RT004   (anywhere in the file: whole file)

Rule catalog lives in `docs/lint.md` (RT007 guards CUDA graph
captures here: `checks.HostEffectInCapture` says how); the checks
themselves are in `ray_tpu_torch/lint/checks.py`.
"""

from ray_tpu_torch.lint.framework import (  # noqa: F401
    Finding,
    compare_to_baseline,
    default_baseline_path,
    lint_paths,
    load_baseline,
    render_baseline,
    rule_catalog,
)
