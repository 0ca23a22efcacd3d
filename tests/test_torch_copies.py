"""Drift guard for the port's copies of the JAX package's jax-free
runtime, serve plane, data and tune libraries.

A module listed in `COPIES` is the `ray_tpu/` original with only the
namespace rewritten (`rewrite`): the package name (`ray_tpu` ->
`ray_tpu_torch`), the session base (`/tmp/ray_tpu` -> `ray_tpu_torch`
under the process's temp dir), the environment-variable prefix (`RT_`
-> `RTT_`), the accelerator resource's keyword (`num_tpus` ->
`num_gpus`, and the train workers' `"TPU"` resource -> `"GPU"`) and the
shared-memory segment prefix (`rt_` -> `rtt_`).
Each must equal its original after that rewrite, so a change to either
side shows here.  A module that changes more is listed in `ADAPTED`
with the test that holds it.
"""

import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_RULES = (
    (re.compile(r"\bray_tpu\b"), "ray_tpu_torch"),
    (re.compile(r"\bRT_"), "RTT_"),
    (re.compile(r"\bnum_tpus\b"), "num_gpus"),
    (re.compile(r"--num-tpus\b"), "--num-gpus"),
)
# the store-name prefix the sweep reaps (the node daemon, adapted,
# creates its stores under the same prefix)
_SHM_RULE = (re.compile(r'prefix: str = "rt_"'), 'prefix: str = "rtt_"')
# the train workers' and the tune trials' accelerator resource is the GPU
_GPU_RULE = (re.compile(r'res\.pop\("TPU", 0\.0\)'), 'res.pop("GPU", 0.0)')
# the session base follows TMPDIR: two checkouts run with temp dirs of
# their own never share a session, an `address="auto"` join or a
# runtime-env cache
_TMP_RULE = (re.compile(r'"/tmp/ray_tpu_torch"'),
             'os.path.join(tempfile.gettempdir(), "ray_tpu_torch")')


def _add_import(text: str, mod: str) -> str:
    """`import mod` among the module-level imports, in sorted order."""
    if re.search(rf"^import {mod}$", text, re.M):
        return text
    lines = text.splitlines(keepends=True)
    for i, line in enumerate(lines):
        m = re.match(r"import (\w+)$|from (?!__future__)\S+ import", line)
        if m and (m.group(1) or "~") > mod:
            lines.insert(i, f"import {mod}\n")
            break
    return "".join(lines)


def rewrite(text: str, rel: str = "") -> str:
    """The namespace rewrite that turns an original into its copy."""
    for pat, sub in _RULES:
        text = pat.sub(sub, text)
    if rel == "shm/__init__.py":
        text = _SHM_RULE[0].sub(_SHM_RULE[1], text)
    if rel in ("train/worker_group.py", "tune/controller.py"):
        text = _GPU_RULE[0].sub(_GPU_RULE[1], text)
    text, n = _TMP_RULE[0].subn(_TMP_RULE[1], text)
    if n:
        text = _add_import(text, "tempfile")
    return text


# paths relative to the package root (`ray_tpu/` and `ray_tpu_torch/`)
COPIES = (
    "exceptions.py",
    "core/__init__.py", "core/ids.py", "core/config.py", "core/wire.py",
    "core/integrity.py", "core/rpc.py", "core/retry.py",
    "core/object_ref.py", "core/completion.py", "core/owner_shard.py",
    "core/task_events.py", "core/storage.py", "core/diskio.py",
    "core/log_stream.py", "core/memory_monitor.py", "core/runtime_env.py",
    "core/container.py", "core/controller.py",
    "core/worker_main.py", "core/node_launcher.py",
    "core/serialization.py",
    "metrics/__init__.py", "metrics/registry.py", "metrics/metric_defs.py",
    "metrics/exporter.py",
    "shm/__init__.py", "shm/shmstore.cc",
    "util/sanitizer.py", "util/tracing.py",
    "util/events.py", "util/profiling.py", "util/httpd.py",
    "util/usage_stats.py", "util/metrics.py", "util/actor_pool.py",
    "util/queue.py", "util/collective.py",
    "train/result.py", "train/checkpoint.py", "train/checkpoint_manager.py",
    "train/backend_executor.py", "train/worker_group.py",
    "train/huggingface.py",
    "serve/__init__.py", "serve/request.py", "serve/slo.py",
    "serve/multiplex.py", "serve/batching.py", "serve/autoscaling.py",
    "serve/request_ledger.py", "serve/handle.py", "serve/router.py",
    "serve/replica.py", "serve/controller.py", "serve/proxy.py",
    "serve/grpc_proxy.py", "serve/api.py",
    "api.py",
    "dag/__init__.py", "dag/dag_node.py", "dag/execution.py",
    "dag/compiled_dag.py",
    "data/__init__.py", "data/block.py", "data/context.py",
    "data/aggregate.py", "data/plan.py", "data/datasource.py",
    "data/tfrecord.py", "data/avro.py", "data/executor.py",
    "data/shuffle.py",
    "tune/__init__.py", "tune/search.py", "tune/schedulers.py",
    "tune/trainable.py", "tune/controller.py", "tune/tuner.py",
)

# module -> the test that holds what it changes
ADAPTED = {
    "__init__.py": "test_torch_isolation.py::"
                   "test_runtime_modules_do_not_import_torch",
    "core/accelerators.py": "test_torch_core.py::"
                            "test_gpu_actors_get_distinct_cards",
    "core/task_spec.py": "test_torch_core.py::"
                         "test_gpu_resources_validate_like_chips",
    "core/env_utils.py": "test_torch_core.py::"
                         "test_port_cluster_ignores_the_jax_packages_env",
    "core/noded.py": "test_torch_core.py::"
                     "test_gpu_actors_get_distinct_cards",
    "core/runtime.py": "test_torch_core.py::"
                       "test_accel_env_warns_after_cuda_init",
    # no slice domain and no slice-gang API on a GPU host
    "core/placement.py": "test_torch_core.py::"
                         "test_strict_pack_ignores_tpu_slice_labels",
    "util/placement_group.py": "test_torch_core.py::"
                               "test_strict_pack_reserves_one_node",
    "util/__init__.py": "test_torch_core.py::"
                        "test_strict_pack_ignores_tpu_slice_labels",
    "util/scheduling_strategies.py": "test_torch_core.py::"
                                     "test_node_label_strategy_matches_jax",
    "serve/config.py": "test_torch_serve.py::"
                       "test_engine_config_names_the_ports_routes",
    "serve/schema.py": "test_torch_serve.py::"
                       "test_schema_matches_jax",
    "serve/llm_engine.py": "test_torch_serve_llm.py::"
                           "test_ledger_counts_match_jax_engine",
    "serve/kv_cache.py": "test_torch_llm_engine.py::"
                         "test_radix_cache_match_insert_evict",
    "examples/serve_llm.py": "test_torch_serve_llm.py::"
                             "test_continuous_service_tokens_equal_generate",
    # the parallel layer over torch.distributed; its host tier is a copy
    # (test_collectives_host_tier_is_a_copy below)
    "parallel/__init__.py": "test_torch_parallel.py::"
                            "test_mesh_layout_matches_jax",
    "parallel/collectives.py": "test_torch_parallel.py::"
                               "test_in_program_collectives_match_jax_lax",
    "parallel/mesh.py": "test_torch_parallel.py::"
                        "test_mesh_layout_matches_jax",
    "parallel/sharding.py": "test_torch_parallel.py::"
                            "test_spec_from_logical_matches_jax",
    "parallel/ring_attention.py": "test_torch_parallel.py::"
                                  "test_sequence_parallel_attention_matches_jax",
    # the train plane: CudaTrainer / CudaConfig / cuda_utils, GPUs in
    # the ScalingConfig, DeviceMesh sessions, DTensor sharded checkpoints
    "train/__init__.py": "test_torch_train.py::"
                         "test_config_names_the_gpu_and_as_trainable_"
                         "wraps_for_tune",
    "train/config.py": "test_torch_train.py::"
                       "test_fractional_gpu_workers_share_the_card",
    "train/trainer.py": "test_torch_train.py::"
                        "test_config_names_the_gpu_and_as_trainable_"
                        "wraps_for_tune",
    "train/backend.py": "test_torch_train_distributed.py::"
                        "test_torch_distributed_builds_the_mesh_and_"
                        "trains_over_it",
    "train/session.py": "test_torch_train_elastic.py::"
                        "test_train_context_get_mesh_refits_when_elastic",
    "train/cuda_utils.py": "test_torch_train.py::"
                           "test_collective_gradient_sync",
    "train/torch.py": "test_torch_train.py::test_torch_trainer_ddp",
    "train/sharded_checkpoint.py": "test_torch_train_distributed.py::"
                                   "test_sharded_checkpoint_format_crosses_"
                                   "both_packages",
    # the compiled graphs' tensor codec carries torch tensors; the ring,
    # spill, relay and geometry code is the original's
    # (test_channel_outside_the_codec_is_a_copy below)
    "dag/channel.py": "test_torch_dag.py::"
                      "test_jax_arrays_arrive_as_torch_tensors_and_back",
    # experts and pipelines over torch.distributed and the port's actors
    "parallel/moe.py": "test_torch_moe.py::"
                       "test_local_forward_aux_and_grads_match_jax",
    "parallel/pipeline.py": "test_torch_pipeline.py::"
                            "test_pipeline_apply_grads_match_jax_not_s_times",
    "parallel/pipeline_dag.py": "test_torch_pipeline.py::"
                                "test_1f1b_matches_serial_loss_and_grads",
    "models/mixtral.py": "test_torch_mixtral.py::"
                         "test_train_steps_match_optax",
    # `iter_jax_batches` becomes `iter_cuda_batches`; the rest is the
    # original's (test_data_outside_the_cuda_feed_is_a_copy below)
    "data/dataset.py": "test_torch_data_ingest.py::"
                       "test_iter_cuda_batches_equals_iter_jax_batches",
    "data/iterator.py": "test_torch_data_ingest.py::"
                        "test_split_iter_cuda_batches_equals_iter_jax_batches",
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_original_after_the_rewrite(rel):
    orig = (REPO / "ray_tpu" / rel).read_text()
    port = (REPO / "ray_tpu_torch" / rel).read_text()
    assert port == rewrite(orig, rel), (
        f"ray_tpu_torch/{rel} drifted from ray_tpu/{rel}; copy it again "
        f"with tests/test_torch_copies.py's rewrite, or move it to ADAPTED"
    )


def test_every_runtime_module_is_a_copy_or_adapted():
    """Each module of the ported subpackages is accounted for, and each
    adapted one names a test that exists."""
    port = REPO / "ray_tpu_torch"
    listed = set(COPIES) | set(ADAPTED)
    for sub in ("core", "metrics", "shm", "util", "serve", "parallel",
                "train", "dag", "data", "tune"):
        for f in (port / sub).iterdir():
            if f.suffix in (".py", ".cc"):
                assert f"{sub}/{f.name}" in listed, f"{sub}/{f.name}"
    for rel, test in ADAPTED.items():
        assert (port / rel).is_file(), rel
        path, name = test.split("::")
        assert f"def {name}(" in (REPO / "tests" / path).read_text(), test


def test_collectives_host_tier_is_a_copy():
    """`parallel/collectives.py` ports its in-program tier to
    torch.distributed; its host tier (`CollectiveGroup` and the module
    functions) is the original's, after the rewrite."""
    mark = "_REDUCERS = {"
    orig = rewrite((REPO / "ray_tpu" / "parallel" / "collectives.py"
                    ).read_text())
    port = (REPO / "ray_tpu_torch" / "parallel" / "collectives.py"
            ).read_text()
    assert port[port.index(mark):] == orig[orig.index(mark):]


def test_channel_outside_the_codec_is_a_copy():
    """`dag/channel.py` ports only its tensor codec (the module's
    docstring says how): its imports, payload kinds and geometry, its
    container constants and exceptions, and the `Channel` class (the
    ring, spill and relay code) are the original's after the rewrite."""
    orig = rewrite((REPO / "ray_tpu" / "dag" / "channel.py").read_text())
    port = (REPO / "ray_tpu_torch" / "dag" / "channel.py").read_text()
    for start, end in (("from __future__ import annotations",
                        "# tensor-header handle kinds"),
                       ("_CONT_SINGLE = 0", "# -- tensor codec"),
                       ("class Channel:", None)):
        o = orig[orig.index(start):orig.index(end) if end else None]
        p = port[port.index(start):port.index(end) if end else None]
        assert p == o, start


@pytest.mark.parametrize("rel,orig_end,port_end,tail", [
    ("data/dataset.py", "    def iter_jax_batches(",
     "    def iter_cuda_batches(", "    def iter_torch_batches("),
    ("data/iterator.py", "    def iter_jax_batches(",
     "    def iter_cuda_batches(", "\n\ndef make_streaming_split("),
])
def test_data_outside_the_cuda_feed_is_a_copy(rel, orig_end, port_end, tail):
    """`data/dataset.py` and `data/iterator.py` port only the feed onto
    the device: from the imports up to `iter_jax_batches`, and from the
    method after it (`iter_torch_batches`, `make_streaming_split`) to
    the end, each is the original's after the rewrite."""
    orig = rewrite((REPO / "ray_tpu" / rel).read_text(), rel)
    port = (REPO / "ray_tpu_torch" / rel).read_text()
    start = "from __future__ import annotations"
    assert (port[port.index(start):port.index(port_end)]
            == orig[orig.index(start):orig.index(orig_end)])
    assert port[port.index(tail):] == orig[orig.index(tail):]


def test_rewrite_keeps_the_namespaces_apart():
    text = ("import os\n"
            "from ray_tpu.core import rpc\n"
            'base = os.environ.get("RT_TMPDIR", "/tmp/ray_tpu")\n'
            'def f(num_tpus=None, prefix: str = "rt_"): '
            'return "rt_serve_requests_total"\n')
    out = rewrite(text, "shm/__init__.py")
    assert ('os.environ.get("RTT_TMPDIR", os.path.join('
            'tempfile.gettempdir(), "ray_tpu_torch"))') in out
    assert out.startswith("import os\nimport tempfile\nfrom ray_tpu_torch")
    assert '"/tmp/' not in out
    assert "from ray_tpu_torch.core import rpc" in out
    assert 'num_gpus=None, prefix: str = "rtt_"' in out
    # metric names keep their prefix: they live in each process's own
    # registry, not in a namespace the two runtimes share
    assert '"rt_serve_requests_total"' in out
    assert rewrite(out, "shm/__init__.py") == out  # idempotent
