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
# the sanitizer harness's build dir and segment prefix: the port's and
# the JAX package's harnesses may run at once and must not share either
_SANITIZER_RULE = (re.compile(r"\brts_sanitizer"), "rtts_sanitizer")
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
    if rel in ("shm/shmstore_stress.cc", "shm/run_sanitizers.sh"):
        text = _SANITIZER_RULE[0].sub(_SANITIZER_RULE[1], text)
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
    "rllib/connectors.py", "rllib/core/__init__.py",
    "rllib/algorithms/__init__.py",
    "rllib/algorithms/algorithm.py", "rllib/env/__init__.py",
    "rllib/env/envs.py", "rllib/env/env_runner.py",
    "rllib/env/env_runner_group.py", "rllib/env/multi_agent.py",
    "cluster_utils.py",
    "job/__init__.py", "job/api.py", "workflow/__init__.py",
    "util/state/__init__.py",
    "dashboard/__init__.py", "dashboard/timeline.py", "dashboard/head.py",
    "dashboard/app.html",
    "autoscaler/__init__.py", "autoscaler/node_provider.py",
    "autoscaler/command_runner.py", "autoscaler/autoscaler.py",
    "autoscaler/v2.py",
    "scripts/cli.py",
    "util/multiprocessing/__init__.py", "util/multiprocessing/pool.py",
    "util/joblib/__init__.py", "util/joblib/ray_backend.py",
    "shm/run_sanitizers.sh",
    "lint/concurrency.py", "lint/jscheck.py",
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
    # rllib's PPO path: the learner and its loss in torch on an explicit
    # device, the landed names only; the runner side is copied (the
    # numpy paths, `compute_gae` and the training steps are the
    # original's: test_rllib_outside_the_torch_learner_is_a_copy below)
    "rllib/__init__.py": "test_torch_isolation.py::"
                         "test_rllib_runner_side_imports_no_torch_or_jax",
    "rllib/algorithms/algorithm_config.py": "test_torch_rllib.py::"
                                            "test_one_ppo_iteration_"
                                            "matches_jax",
    "rllib/algorithms/ppo.py": "test_torch_rllib.py::"
                               "test_ppo_loss_and_grad_match_jax",
    "rllib/core/rl_module.py": "test_torch_rllib.py::"
                               "test_cnn_forward_matches_jax",
    "rllib/core/learner.py": "test_torch_rllib.py::"
                             "test_learner_update_matches_jax",
    "rllib/bench.py": "test_torch_rllib_algo.py::"
                      "test_fleet_bench_row_accounts_exactly",
    # the rest of rllib's algorithms: each loss in torch, the learner
    # group on the learner's device, DQN's, SAC's and CQL's target
    # forwards eager and no-grad on target params kept on that device;
    # the numpy paths and training steps are the originals'
    # (test_rllib_algorithms_outside_the_torch_learner_are_copies below)
    "rllib/algorithms/appo.py": "test_torch_rllib_vtrace.py::"
                                "test_loss_and_grad_match_jax",
    "rllib/algorithms/impala.py": "test_torch_rllib_vtrace.py::"
                                  "test_update_matches_jax",
    "rllib/algorithms/dqn.py": "test_torch_rllib_replay.py::"
                               "test_td_targets_match_the_jitted_jax_"
                               "functions",
    "rllib/algorithms/sac.py": "test_torch_rllib_replay.py::"
                               "test_loss_and_grad_match_jax",
    "rllib/algorithms/cql.py": "test_torch_rllib_offline.py::"
                               "test_cql_td_targets_match_the_jitted_jax_"
                               "forward",
    "rllib/algorithms/bc.py": "test_torch_rllib_offline.py::"
                              "test_loss_and_grad_match_jax",
    "rllib/algorithms/marwil.py": "test_torch_rllib_offline.py::"
                                  "test_gang_form_equals_the_whole_batch",
    # multi-agent PPO: a learner group a module on the learner's device
    # (test_rllib_outside_the_torch_learner_is_a_copy below); DreamerV3:
    # the world model, imagination and both updates in torch, the
    # config, replay and the runners' numpy policy the original's
    # (test_rllib_algorithms_outside_the_torch_learner_are_copies below)
    "rllib/algorithms/multi_agent_ppo.py": "test_torch_rllib_multi_agent.py::"
                                           "test_one_training_step_matches_"
                                           "jax",
    "rllib/algorithms/dreamer.py": "test_torch_rllib_dreamer.py::"
                                   "test_wm_and_ac_updates_match_the_jitted_"
                                   "jax_ones",
    # the examples on the port's trainer and PPO, on `device`
    # (test_examples_outside_the_device_are_copies below)
    "examples/ppo_pixels.py": "test_torch_examples.py::"
                              "test_ppo_pixels_example",
    "examples/mnist.py": "test_torch_examples.py::test_mnist_fashion_ddp",
    # the fault injectors are copies; the JAX probes become a gloo probe
    # and a kernel probe (test_testing_outside_the_probes_is_a_copy below)
    "testing.py": "test_torch_testing.py::"
                  "test_cuda_kernel_support_answers_for_each_family",
    # the operations plane: the workflow store's own variable and
    # directory, the kernel-rate panel's wording, GKE's GPU pod shape
    # (test_ops_plane_outside_its_adaptations_is_a_copy below)
    "workflow/api.py": "test_torch_workflow.py::"
                       "test_storage_root_is_not_the_jax_packages",
    "dashboard/grafana.py": "test_torch_dashboard.py::"
                            "test_grafana_speaks_of_the_card",
    "autoscaler/gke.py": "test_torch_autoscaler.py::test_gpu_pod_shape",
    # the cluster launcher on Compute Engine's instance API: GPU VMs,
    # one bulkInsert a gang, a machine type in place of a slice type
    "autoscaler/gcp.py": "test_torch_launcher.py::"
                         "test_gang_is_a_single_bulk_insert",
    "autoscaler/commands.py": "test_torch_launcher.py::"
                              "test_up_down_roundtrip",
    # the pod helpers answer None (a GPU host is in no slice); the chip
    # helpers read the cards
    "util/accelerators.py": "test_torch_multiprocessing.py::"
                            "test_util_accelerators_read_the_cards",
    # the shm stress harness names its segment after its process
    "shm/shmstore_stress.cc": "test_torch_sanitizers.py::"
                              "test_harness_builds_the_ports_store",
    # rtlint over the port's tree: its own baseline and default paths,
    # RT007 guarding CUDA graph captures
    # (test_lint_outside_its_adaptations_is_a_copy below)
    "lint/__init__.py": "test_torch_lint.py::"
                        "test_port_tree_is_clean_against_its_baseline",
    "lint/__main__.py": "test_torch_lint.py::test_cli_runs_clean",
    "lint/framework.py": "test_torch_lint.py::"
                         "test_port_tree_is_clean_against_its_baseline",
    "lint/checks.py": "test_torch_lint.py::test_rt007_capture_positive",
    # the perf harness: no JAX, an explicit device, the decode route's
    # name, the elastic row on CudaTrainer
    # (test_perf_outside_its_adaptations_is_a_copy below)
    "scripts/perf.py": "test_torch_perf_harness.py::"
                       "test_engine_and_decode_rows_match_jax",
    # the counterpart of `__graft_entry__.py`'s entry points (beside the
    # JAX package) on a process group
    "dryrun.py": "test_torch_dryrun.py::"
                 "test_dryrun_gpt2_step_matches_reference",
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
                "train", "dag", "data", "tune", "rllib", "rllib/core",
                "rllib/algorithms", "rllib/env", "job", "workflow",
                "util/state", "dashboard", "autoscaler",
                "util/multiprocessing", "util/joblib", "lint"):
        for f in (port / sub).iterdir():
            if f.suffix in (".py", ".cc", ".html", ".sh"):
                assert f"{sub}/{f.name}" in listed, f"{sub}/{f.name}"
    for f in port.glob("*.py"):
        assert f.name in listed, f.name
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


@pytest.mark.parametrize("rel,sections", [
    # the loss is torch; the learner group takes the learner's device
    ("rllib/algorithms/ppo.py", (
        ("from __future__ import annotations", "def make_ppo_loss("),
        ("ppo_loss = make_ppo_loss()", "        self.learner_group = "),
        ("        self.env_runner_group.sync_weights(", None))),
    # no XLA flags: the learner sits on `device`
    ("rllib/bench.py", (("    try:\n        algo.train()", None),)),
    # `learners(device=...)`
    ("rllib/algorithms/algorithm_config.py", (
        ("from __future__ import annotations", "class AlgorithmConfig:"),
        ("        self.env_to_module_connector", "    # -- fluent"),
        ("    def training(", None))),
    # each module's learner group takes `device=cfg.learner_device`
    ("rllib/algorithms/multi_agent_ppo.py", (
        ("from __future__ import annotations",
         "                seed=cfg.seed + i, mesh=cfg.mesh,"),
        ("            for i, mid in enumerate(module_ids)", None))),
])
def test_rllib_outside_the_torch_learner_is_a_copy(rel, sections):
    """The adapted rllib modules port only the learner's side: each
    section named here (from its first marker up to its second) is the
    original's after the rewrite."""
    orig = rewrite((REPO / "ray_tpu" / rel).read_text(), rel)
    port = (REPO / "ray_tpu_torch" / rel).read_text()
    for start, end in sections:
        o = orig[orig.index(start):orig.index(end, orig.index(start))
                 if end else None]
        p = port[port.index(start):port.index(end, port.index(start))
                 if end else None]
        assert p == o, (rel, start)


def _defs(text: str) -> dict:
    """Source of each top-level function and each method, by qualified
    name."""
    import ast

    tree = ast.parse(text)
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = \
                        ast.get_source_segment(text, sub)
    return out


def test_rllib_numpy_paths_are_the_originals():
    """`rl_module.py` ports the modules' torch half; their numpy half
    (the runners' forward), the conv arithmetic and the module choice
    are the original's, function by function; `compute_gae` and the
    training steps of `ppo.py` too."""
    for rel, names in (
            ("rllib/core/rl_module.py", (
                "MLPModule.__init__", "MLPModule._tower_dims",
                "MLPModule.forward_numpy", "conv_out_dims",
                "CNNModule.__init__",
                "CNNModule._encode_numpy", "CNNModule.forward_numpy",
                "_conv2d_numpy", "tower_numpy", "make_default_module",
                "require_flat_obs", "require_discrete_actions")),
            ("rllib/algorithms/ppo.py", (
                "compute_gae", "PPO._postprocess", "PPO._update_epochs",
                "PPO.training_step", "PPO._collect_pairs",
                "PPO._training_step_overlap", "PPO.get_state",
                "PPO.set_state", "PPO.stop"))):
        orig = _defs(rewrite((REPO / "ray_tpu" / rel).read_text(), rel))
        port = _defs((REPO / "ray_tpu_torch" / rel).read_text())
        for name in names:
            assert port[name] == orig[name], (rel, name)


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


def test_testing_outside_the_probes_is_a_copy():
    """`testing.py` keeps the original's fault injectors
    (`list_workers`, `kill_random_worker`, `WorkerKiller`) and replaces
    its JAX probes: everything up to the probes is the original's after
    the rewrite."""
    orig = rewrite((REPO / "ray_tpu" / "testing.py").read_text())
    port = (REPO / "ray_tpu_torch" / "testing.py").read_text()
    mark = "# environment capability probes"
    assert port[:port.index(mark)] == orig[:orig.index(mark)]


# a training step's one port line: the online params cross to the
# learner's device once an iteration (the target forwards run there)
_ONLINE_RULE = (re.compile(
    r"self\._on_learner_device\(\n\s+self\.learner_group\."
    r"get_weights_numpy\(\)\)"), "self.learner_group.get_weights_numpy()")

_ALGO_COPIED = {
    "rllib/algorithms/appo.py": (
        "APPOConfig.__init__", "APPOConfig.algo_class", "compute_vtrace",
        "APPO._current_forward", "APPO.training_step", "APPO.get_state",
        "APPO.set_state", "APPO.stop", "_logsumexp"),
    "rllib/algorithms/impala.py": (
        "IMPALAConfig.__init__", "IMPALAConfig.algo_class",
        "IMPALA._vtrace_batch", "IMPALA.training_step", "IMPALA.get_state",
        "IMPALA.set_state", "IMPALA.stop"),
    "rllib/algorithms/dqn.py": (
        "QMLPModule.select_actions_numpy", "DQNConfig.__init__",
        "DQNConfig.algo_class", "ReplayBuffer.__init__",
        "ReplayBuffer.__len__", "ReplayBuffer.add_batch",
        "ReplayBuffer.sample", "_transitions", "DQN._epsilon",
        "DQN.training_step", "DQN.get_state", "DQN.set_state", "DQN.stop"),
    "rllib/algorithms/sac.py": (
        "SACModule.forward_numpy", "ContinuousSACModule.__init__",
        "ContinuousSACModule.select_actions_numpy",
        "ContinuousSACModule.forward_numpy", "SACConfig.__init__",
        "SACConfig.algo_class", "SAC.training_step", "SAC.get_state",
        "SAC.set_state", "SAC.stop"),
    "rllib/algorithms/cql.py": (
        "CQLConfig.__init__", "CQLConfig.offline_data",
        "CQLConfig.evaluation", "CQLConfig.algo_class", "_load_dataset",
        "CQL.training_step", "CQL.evaluate", "CQL.get_state",
        "CQL.set_state", "CQL.stop"),
    "rllib/algorithms/bc.py": (
        "BCConfig.__init__", "BCConfig.offline_data", "BCConfig.algo_class",
        "_coerce_offline", "BC._loss_fn", "BC._prepare_dataset",
        "BC.training_step", "BC.get_state", "BC.set_state", "BC.stop"),
    "rllib/algorithms/marwil.py": (
        "MARWILConfig.__init__", "MARWILConfig.training",
        "MARWILConfig.algo_class", "discounted_returns",
        "_coerce_offline_marwil", "MARWIL._loss_fn",
        "MARWIL._prepare_dataset", "MARWIL.training_step"),
    "rllib/algorithms/dreamer.py": (
        "DreamerConfig.__init__", "DreamerConfig.algo_class",
        "DreamerModel.__init__", "Dreamer._add_to_replay",
        "Dreamer._sample_segments", "Dreamer.stop",
        "_DreamerPolicy.__init__", "_DreamerPolicy._np_mlp",
        "_DreamerPolicy._np_encode", "_DreamerPolicy.forward_numpy"),
}


@pytest.mark.parametrize("rel", list(_ALGO_COPIED))
def test_rllib_algorithms_outside_the_torch_learner_are_copies(rel):
    """Each algorithm ports its loss, its learner group's device and its
    target forwards; its configs, numpy helpers (v-trace, the replay
    buffer, the dataset readers, discounted returns, DreamerV3's
    replay), runner-side policies (DreamerV3's `_DreamerPolicy`), state
    and training steps are the original's, function by function (the
    training steps of DQN, SAC and CQL after their one port line,
    `_ONLINE_RULE`)."""
    orig = _defs(rewrite((REPO / "ray_tpu" / rel).read_text(), rel))
    port = _defs(_ONLINE_RULE[0].sub(
        _ONLINE_RULE[1], (REPO / "ray_tpu_torch" / rel).read_text()))
    for name in _ALGO_COPIED[rel]:
        assert port[name] == orig[name], (rel, name)


@pytest.mark.parametrize("rel,sections", [
    # `run(device=...)` reaches the learner; the rest is the original's
    ("examples/ppo_pixels.py", (
        ("from __future__ import annotations", "def run("),
        ("    cfg = (PPOConfig()", "           .learners("),
        ("           .debugging(seed=seed))", None))),
    # the dataset and the script's entry are the original's
    ("examples/mnist.py", (
        ("def make_dataset(", "def train_func("),
        ('if __name__ == "__main__":', None))),
])
def test_examples_outside_the_device_are_copies(rel, sections):
    """The examples port their train loop (mnist: the torch MLP on the
    worker's device) and their device argument; each section named
    here is the original's after the rewrite."""
    orig = rewrite((REPO / "ray_tpu" / rel).read_text(), rel)
    port = (REPO / "ray_tpu_torch" / rel).read_text()
    for start, end in sections:
        o = orig[orig.index(start):orig.index(end, orig.index(start))
                 if end else None]
        p = port[port.index(start):port.index(end, port.index(start))
                 if end else None]
        assert p == o, (rel, start)



_WF_DOC = '''

The store root is `RTT_WORKFLOW_STORAGE`, else `workflows/` under the
port's session base (`RTT_TMPDIR`, else `ray_tpu_torch` in the temp
dir), so the JAX package's store is never shared.  Step outputs are
pickled with their devices: a step that returns host values (CPU
tensors, numpy) can be read back by a process without a card.
"""'''


def _lines(*lines: str) -> str:
    return "\n".join(lines) + "\n"


# each adapted module of the operations plane as (port text, the
# rewritten original's text) pairs; undone, the module is the original
_OPS_ADAPTATIONS = {
    "workflow/api.py": (
        (_WF_DOC, '\n"""'),
        ("import tempfile\n", ""),
        (_lines(
            "        # the port's own variable and directory, under its session",
            "        # base: the JAX package's `RAY_TPU_WORKFLOW_STORAGE` and",
            "        # `/tmp/ray_tpu/workflows` are never read or written here",
            "        _storage_dir = os.environ.get(",
            '            "RTT_WORKFLOW_STORAGE",',
            "            os.path.join(",
            '                os.environ.get("RTT_TMPDIR", os.path.join(',
            '                    tempfile.gettempdir(), "ray_tpu_torch")),',
            '                "workflows",',
            "            ),",
            "        )"),
         _lines(
             "        _storage_dir = os.environ.get(",
             '            "RAY_TPU_WORKFLOW_STORAGE", '
             '"/tmp/ray_tpu_torch/workflows"',
             "        )")),
    ),
    "dashboard/grafana.py": (
        ("a zero kernel rate on the card means",
         "a zero kernel rate on TPU means"),
    ),
    "autoscaler/gke.py": (
        (_lines(
            "API) and node identity is the pod name.  GKE GPU specifics "
            "follow the",
            "documented pod shape: `nvidia.com/gpu` resource limits from a "
            "node",
            'type\'s `"GPU"` resource, plus the '
            "`cloud.google.com/gke-accelerator`",
            "node selector (for example `nvidia-h100-80gb`); a multi-host "
            "gang maps",
            "to `hosts` pods sharing a `tpu-slice` label so STRICT_PACK "
            "placement",
            "sees one domain."),
         _lines(
             "API) and node identity is the pod name.  GKE TPU specifics "
             "follow the",
             "documented pod shape: `google.com/tpu` resource limits plus "
             "the",
             "`cloud.google.com/gke-tpu-accelerator` / `gke-tpu-topology` "
             "node",
             "selectors; a multi-host slice maps to `hosts` pods sharing a",
             "`tpu-slice` label so STRICT_PACK placement sees one ICI "
             "domain.")),
        (_lines('        gpu_accelerator: Optional[str] = None,  '
                '# e.g. "nvidia-h100-80gb"'),
         _lines('        tpu_accelerator: Optional[str] = None,  '
                '# e.g. "tpu-v5-lite-podslice"',
                '        tpu_topology: Optional[str] = None,     '
                '# e.g. "2x4"')),
        (_lines("        self.gpu_accelerator = gpu_accelerator"),
         _lines("        self.tpu_accelerator = tpu_accelerator",
                "        self.tpu_topology = tpu_topology")),
        (_lines('        gpus = resources.get("GPU")',
                "        if gpus:",
                '            limits["nvidia.com/gpu"] = str(int(gpus))'),
         _lines('        tpus = resources.get("TPU")',
                "        if tpus:",
                '            limits["google.com/tpu"] = str(int(tpus))')),
        (_lines("        if gpus and self.gpu_accelerator:",
                '            selector["cloud.google.com/gke-accelerator"] = (',
                "                self.gpu_accelerator",
                "            )"),
         _lines("        if tpus and self.tpu_accelerator:",
                '            selector["cloud.google.com/gke-tpu-accelerator"]'
                " = (",
                "                self.tpu_accelerator",
                "            )",
                "        if tpus and self.tpu_topology:",
                '            selector["cloud.google.com/gke-tpu-topology"] = '
                "self.tpu_topology")),
        (_lines('        if "nvidia.com/gpu" in limits:',
                '            out["GPU"] = float(limits["nvidia.com/gpu"])'),
         _lines('        if "google.com/tpu" in limits:',
                '            out["TPU"] = float(limits["google.com/tpu"])')),
    ),
}


@pytest.mark.parametrize("rel", list(_OPS_ADAPTATIONS))
def test_ops_plane_outside_its_adaptations_is_a_copy(rel):
    """The adapted modules of the operations plane change only what
    `_OPS_ADAPTATIONS` lists (the workflow store's root, the
    kernel-rate panel's wording, GKE's GPU pod shape): each listed port
    text occurs once, and with each put back as the original's, the
    module is the original after the rewrite."""
    port = (REPO / "ray_tpu_torch" / rel).read_text()
    for new, old in _OPS_ADAPTATIONS[rel]:
        assert port.count(new) == 1, (rel, new)
        port = port.replace(new, old)
    assert port == rewrite((REPO / "ray_tpu" / rel).read_text(), rel)


# each adapted module of the port's rtlint as (port text, the rewritten
# original's text) pairs; undone, the module is the original
_LINT_ADAPTATIONS = {
    "lint/__init__.py": (
        (_lines(
            "Findings on the port's checked-in "
            "`ray_tpu_torch/lint/lint_baseline.json`",
            "(the JAX package's root `lint_baseline.json` is that tree's "
            "own) are",
            "grandfathered by (path, rule) count: CI fails only on NEW "
            "violations,",
            "and a grandfathered count can only shrink.")[:-1],
         _lines(
             "Findings on the checked-in `lint_baseline.json` are "
             "grandfathered by",
             "(path, rule) count: CI fails only on NEW violations, and a "
             "grandfathered",
             "count can only shrink.")[:-1]),
        (_lines(
            "Rule catalog lives in `docs/lint.md` (RT007 guards CUDA graph",
            "captures here: `checks.HostEffectInCapture` says how); the "
            "checks",
            "themselves are in `ray_tpu_torch/lint/checks.py`."),
         _lines(
             "Rule catalog lives in `docs/lint.md`; the checks themselves "
             "are in",
             "`ray_tpu_torch/lint/checks.py`.")),
    ),
    "lint/__main__.py": (
        (_lines(
            "2 usage error.  `--write-baseline` regenerates the port's",
            "`ray_tpu_torch/lint/lint_baseline.json` from the current "
            "findings",
            "(review the diff: it should only shrink)."),
         _lines(
             "2 usage error.  `--write-baseline` regenerates "
             "`lint_baseline.json`",
             "from the current findings (review the diff: it should only "
             "shrink).")),
        ("import argparse\nimport glob\n", "import argparse\n"),
        (_lines(
            '        help="files/directories to lint (default: ray_tpu_torch '
            'and "',
            '        "tests/test_torch_*.py)",'),
         _lines('        help="files/directories to lint (default: '
                'ray_tpu_torch tests)",')),
        (_lines(
            '        *sorted(glob.glob(os.path.join(_REPO_ROOT, "tests",',
            '                                       "test_torch_*.py"))),'),
         _lines('        os.path.join(_REPO_ROOT, "tests"),')),
    ),
    "lint/framework.py": (
        (_lines(
            "def default_baseline_path() -> str:",
            '    """The port\'s own baseline, beside this package: the JAX '
            "package's",
            '    `lint_baseline.json` at the repo root grandfathers its tree '
            'only."""',
            "    return os.path.join(os.path.dirname(os.path.abspath("
            "__file__)),",
            '                        "lint_baseline.json")'),
         _lines("def default_baseline_path() -> str:",
                '    return os.path.join(_REPO_ROOT, "lint_baseline.json")')),
    ),
}


@pytest.mark.parametrize("rel", list(_LINT_ADAPTATIONS))
def test_lint_outside_its_adaptations_is_a_copy(rel):
    """The port's rtlint changes only its baseline's place and its
    default paths (the port's tree and its tests): each listed port
    text occurs once, and with each put back as the original's, the
    module is the original after the rewrite."""
    port = (REPO / "ray_tpu_torch" / rel).read_text()
    for new, old in _LINT_ADAPTATIONS[rel]:
        assert port.count(new) == 1, (rel, new)
        port = port.replace(new, old)
    assert port == rewrite((REPO / "ray_tpu" / rel).read_text(), rel)


def test_lint_checks_outside_rt007_are_the_originals():
    """`lint/checks.py` ports RT007 alone (CUDA graph captures in place
    of `jax.jit`): the module up to that rule's class and from the next
    rule on is the original's after the rewrite."""
    orig = rewrite((REPO / "ray_tpu" / "lint" / "checks.py").read_text())
    port = (REPO / "ray_tpu_torch" / "lint" / "checks.py").read_text()
    nxt = "# " + "-" * 70 + "\n@register\nclass UnseededRandomInTests"
    assert (port[:port.index("class HostEffectInCapture(Check):")]
            == orig[:orig.index("class HostEffectInJit(Check):")])
    assert port[port.index(nxt):] == orig[orig.index(nxt):]


# the perf harness's adaptations as (port text, the rewritten original's
# text, times it occurs); undone, the module is the original.  Its env
# knobs (`RTT_OBJECT_INTEGRITY`, `RTT_DISK_CHAOS`, `RTT_METRICS_ENABLED`)
# are the rewrite's own
_PERF_ADAPTATIONS = {
    # the observability A/B's repair: rounds in ABBA order, each group
    # read by its fastest storm, and the serve half's tiny engine on one
    # intra-op thread on the CPU (undone first: its import sits inside
    # the text `no_jax` undoes)
    "obs_ab": (
        (_lines("def _fastest_overhead(off: List[float], on: List[float]) "
                "-> float:",
                '    """The \'on\' group\'s cost in % of the \'off\' '
                "group's throughput, each",
                "    group read by its fastest storm: on a shared host other "
                "load only",
                "    ever slows a storm, so the fastest is the least "
                "disturbed, where the",
                "    median of two rounds is their mean and one stalled "
                "storm (6.5x",
                "    slower beside a parallel test run) carried it past any "
                'budget."""',
                "    return round(100.0 * (1.0 - max(on) / max(off)), 2)",
                "", ""), "", 1),
        ("    Methodology — alternating in-cluster A/B, fastest storms "
         "compared: the",
         "    Methodology — alternating in-cluster A/B, medians compared: "
         "the", 1),
        (_lines("    cost, alternation cancels drift, and comparing each "
                "group's FASTEST",
                "    storm drops the stalled ones.  The 'on' phases "
                "self-validate"),
         _lines("    cost, alternation cancels drift, and comparing group "
                "MEDIANS",
                "    suppresses the per-storm outliers.  The 'on' phases "
                "self-validate"), 1),
        (_lines('            "overhead_pct": _fastest_overhead(off_tps, '
                'on_tps),',
                '            "metrics_off_tasks_per_s": round(max(off_tps), '
                '1),',
                '            "metrics_on_tasks_per_s": round(max(on_tps), '
                '1),'),
         _lines('            "overhead_pct": round(100.0 * (1.0 - med_on / '
                'med_off), 2),',
                '            "metrics_off_tasks_per_s": round(med_off, 1),',
                '            "metrics_on_tasks_per_s": round(med_on, 1),'),
         1),
        ("    Same alternating, fastest-storm methodology as the task-storm "
         "half: ONE",
         "    Same alternating-median methodology as the task-storm half: "
         "ONE", 1),
        (_lines('            "overhead_pct": _fastest_overhead(off_tps, '
                'on_tps),',
                '            "ledger_off_tokens_per_sec": '
                'round(max(off_tps), 1),',
                '            "ledger_on_tokens_per_sec": round(max(on_tps), '
                '1),'),
         _lines('            "overhead_pct": round(100.0 * (1.0 - med_on / '
                'med_off), 2),',
                '            "ledger_off_tokens_per_sec": round(med_off, 1),',
                '            "ledger_on_tokens_per_sec": round(med_on, 1),'),
         1),
        (_lines("def _abba(rounds: int) -> List[bool]:",
                '    """The \'on\' flags of `rounds` off/on rounds in ABBA '
                "order (off, on,",
                "    on, off, ...): a load that drifts across the rounds "
                "weighs on both",
                "    groups alike, where off-then-on every round gives it to "
                '\'on\'."""',
                "    return [on for i in range(rounds)",
                "            for on in ((False, True) if i % 2 == 0 else "
                "(True, False))]",
                "", ""), "", 1),
        (_lines("        for on in _abba(rounds):",
                "            _md.set_enabled(on)",
                "            if not on:",
                "                off_tps.append(",
                '                    measure_task_storm(rt, n=storm_n)'
                '["tasks_per_s"])',
                "                continue"),
         _lines("        for _ in range(rounds):",
                "            _md.set_enabled(False)",
                '            off_tps.append(measure_task_storm(rt, n=storm_n)'
                '["tasks_per_s"])',
                "            _md.set_enabled(True)"), 1),
        (_lines("    import statistics as _stats", "", "    import torch", ""),
         _lines("    import statistics as _stats", ""), 1),
        (_lines("    # on the CPU the tiny engine runs on one intra-op "
                "thread: its ops",
                "    # gain nothing from a pool, and on a busy host the "
                "pool's barrier",
                "    # waits, not the ledger, decided a storm's time "
                "(tokens/s swung 6x",
                "    # between storms of one phase)",
                "    threads = torch.get_num_threads()",
                '    if eng.device.type == "cpu":',
                "        torch.set_num_threads(1)"), "", 1),
        (_lines("        for on in _abba(rounds):",
                "            _md.set_enabled(on)",
                "            if not on:",
                "                off_tps.append(_storm(eng))",
                "                continue"),
         _lines("        for _ in range(rounds):",
                "            _md.set_enabled(False)",
                "            off_tps.append(_storm(eng))",
                "            _md.set_enabled(True)"), 1),
        ("        torch.set_num_threads(threads)\n", "", 1),
    ),
    # no JAX: the port's seeded init on the device, no PRNG key
    "no_jax": (
        ("    params = llama.init_params(cfg, seed, device=device)\n",
         "    params = llama.init_params(cfg, jax.random.PRNGKey(seed))\n",
         4),
        ('    """\n    from ray_tpu_torch.models import llama\n',
         '    """\n    import jax\n\n    from ray_tpu_torch.models import llama\n',
         2),
        ('    """\n    from ray_tpu_torch import exceptions as exc\n',
         '    """\n    import jax\n\n    from ray_tpu_torch import exceptions '
         'as exc\n', 1),
        (_lines("    import statistics as _stats",
                "",
                "    from ray_tpu_torch.metrics import metric_defs as _md",
                "    from ray_tpu_torch.models import llama"),
         _lines("    import statistics as _stats",
                "",
                "    import jax",
                "",
                "    from ray_tpu_torch.metrics import metric_defs as _md",
                "    from ray_tpu_torch.models import llama"), 1),
    ),
    # an explicit device: the engine rows and rllib_ppo's learner on
    # `--device`, None meaning the card
    "device": (
        ("# serve LLM engine: paged-KV tick trace + CB smoke (tiny model)",
         "# serve LLM engine: paged-KV tick trace + CB smoke (CPU tiny "
         "model)", 1),
        (_lines("                         seed: int = 0, device=None",
                "                         ) -> Dict[str, Dict[str, float]]:",
                '    """Paged-KV acceptance rows on the tiny model (the '
                "per-chip",
                "    claims, measured without the serve stack in the way), "
                "its engines",
                "    on `device` (None: the card):"),
         _lines("                         seed: int = 0) -> Dict[str, "
                "Dict[str, float]]:",
                '    """Paged-KV acceptance rows on the CPU tiny model (the '
                "per-chip",
                "    claims, measured without the serve stack in the way):"),
         1),
        ("prefix_cache=False, device=device, **kw)",
         "prefix_cache=False, **kw)", 1),
        ("max_len=48, prefix_cache=pc, device=device)",
         "max_len=48, prefix_cache=pc)", 1),
        ("                      max_len=48, device=device)\n",
         "                      max_len=48)\n", 2),
        (_lines("                          seed: int = 0, device=None",
                "                          ) -> Dict[str, Dict[str, "
                "float]]:"),
         _lines("                          seed: int = 0) -> Dict[str, "
                "Dict[str, float]]:"), 1),
        (_lines("    The engines run on `device` (None: the card).  On the "
                "CPU the",
                "    kernel route dispatches the kernels' plain PyTorch "
                "versions, so CPU",
                "    tok/s compares two eager routes — the rows are "
                "structural evidence",
                "    (kernel route dispatched, gather plane dead), not a "
                "speed claim.",
                "    On the card the kernel route launches the fused K5 + "
                "K6 op from",
                "    the chunk's CUDA graph, and the same rows are the perf "
                "claim."),
         _lines("    Off-TPU the kernel runs in Pallas interpret mode, so "
                "CPU tok/s",
                "    compares an interpreter against compiled XLA — the rows "
                "are",
                "    structural evidence (kernel dispatched, gather plane "
                "dead), not a",
                "    speed claim.  On TPU the same rows are the perf "
                "claim."), 1),
        (_lines("                              prefix_cache=False, "
                "decode_kernel=mode,",
                "                              device=device)"),
         _lines("                              prefix_cache=False, "
                "decode_kernel=mode)"), 1),
        ("prefix_cache=False, kv_dtype=kvd, device=device)",
         "prefix_cache=False, kv_dtype=kvd)", 1),
        (_lines("def measure_overload(*, overflow: int = 12, seed: int = 0, "
                "device=None",
                "                     ) -> Dict[str, Dict[str, float]]:",
                '    """Overload-plane acceptance rows on the tiny engine, '
                "on `device`",
                "    (None: the card) (admission control + deadline "
                "shedding, no serve",
                "    stack in the way):"),
         _lines("def measure_overload(*, overflow: int = 12, seed: int = 0",
                "                     ) -> Dict[str, Dict[str, float]]:",
                '    """Overload-plane acceptance rows on the CPU tiny engine '
                "(admission",
                "    control + deadline shedding, no serve stack in the "
                "way):"), 1),
        ("max_queued=queue_cap, device=device)", "max_queued=queue_cap)", 1),
        (_lines("                               rounds: int = 6, seed: int "
                "= 0,",
                "                               device=None,"),
         _lines("                               rounds: int = 6, seed: int "
                "= 0,"), 1),
        (_lines("    batching hot path (tiny model on `device`, None: the "
                "card;",
                "    in-process engine, no cluster)."),
         _lines("    batching hot path (CPU tiny model, in-process engine, "
                "no cluster)."), 1),
        (_lines('                        "prefix reuse, CB smoke (tiny model '
                'on --device; "',
                '                        "no cluster)")'),
         _lines('                        "prefix reuse, CB smoke (CPU tiny '
                'model; no "',
                '                        "cluster)")'), 1),
        (_lines('    p.add_argument("--device", default=None,',
                '                   help="where the engine rows '
                '(--engine-trace, "',
                '                        "--overload, decode_kernel, '
                "obs_overhead's serve \"",
                '                        "half) and rllib_ppo\'s learner '
                "run: 'cuda' \"",
                '                        "(default: the card, raising '
                "without one) or \"",
                '                        "\'cpu\'; the runtime rows use no '
                'device")'), "", 1),
        (_lines("            compare_sync=False,",
                "            device=args.device,"),
         _lines("            compare_sync=False,"), 1),
        (_lines("        results = measure_decode_kernel(batches=batches,",
                "                                        device=args.device)"),
         _lines("        results = measure_decode_kernel(batches=batches)"),
         1),
        (_lines("            requests=args.obs_serve_requests, "
                "rounds=args.obs_rounds,",
                "            device=args.device,"),
         _lines("            requests=args.obs_serve_requests, "
                "rounds=args.obs_rounds,"), 1),
        ("# no cluster: the engine is driven in-process on --device",
         "# no cluster: the engine is driven in-process on the CPU backend",
         1),
        ("requests=args.engine_requests, device=args.device",
         "requests=args.engine_requests", 1),
        ("overflow=args.overload_overflow, device=args.device",
         "overflow=args.overload_overflow", 1),
    ),
    # the decode route is the port engine's "kernel", not "pallas"
    "route_name": (
        ("`decode_b{B}_{kernel,gather}`", "`decode_b{B}_{pallas,gather}`", 1),
        ('for mode in ("kernel", "gather"):',
         'for mode in ("pallas", "gather"):', 1),
        (_lines('                        "rllib_ppo: EnvRunner fleet -> '
                'learner gang "',
                '                        "on --device with async overlap, '
                'env-steps/s + "'),
         _lines('                        "rllib_ppo: EnvRunner fleet -> pjit '
                'learner "',
                '                        "gang with async overlap, '
                'env-steps/s + "'), 1),
    ),
    # elastic recovery on the port's trainer; its loop imports no torch
    "elastic": (
        ("    (no torch) so the measured MTTR",
         "    (no jax) so the measured MTTR", 1),
        ("CudaConfig, CudaTrainer, FailureConfig, RunConfig, ScalingConfig,",
         "FailureConfig, JaxConfig, JaxTrainer, RunConfig, ScalingConfig,",
         1),
        ("    trainer = CudaTrainer(", "    trainer = JaxTrainer(", 1),
        ('cuda_config=CudaConfig(distributed_mode="none"),',
         'jax_config=JaxConfig(distributed_mode="none"),', 1),
    ),
}


def test_perf_outside_its_adaptations_is_a_copy():
    """`scripts/perf.py` changes only what `_PERF_ADAPTATIONS` lists: the
    observability A/B's ABBA rounds, fastest storms compared and
    one-thread serve half, no JAX (the port's seeded `init_params`), an
    explicit device for the
    engine rows and the learner (`--device`, None meaning the card),
    the decode route's name (`kernel` for `pallas`) and the elastic row
    on `CudaTrainer`.  Each listed port text occurs as often as listed,
    and with each put back as the original's, the module is the
    original after the rewrite (which also renames its env knobs)."""
    port = (REPO / "ray_tpu_torch" / "scripts" / "perf.py").read_text()
    for what, pairs in _PERF_ADAPTATIONS.items():
        for new, old, times in pairs:
            assert port.count(new) == times, (what, new)
            port = port.replace(new, old)
    orig = (REPO / "ray_tpu" / "scripts" / "perf.py").read_text()
    assert port == rewrite(orig, "scripts/perf.py")
