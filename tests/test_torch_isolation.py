"""The port stands alone: `ray_tpu_torch` and `chip_smoke.py` import
neither JAX (nor its ecosystem) nor anything of `ray_tpu`, and the
port's entry points run on the card unless the caller asks for the
CPU — without a card they raise instead of carrying on silently.  The
port's runtime (daemons, workers, the serve plane) boots and serves
with JAX and `ray_tpu` blocked in every process it starts, and imports
no torch of its own.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_files():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


# the runtime and serve plane's modules, each of which the scan must see
RUNTIME_MODULES = (
    "api.py", "core/noded.py", "core/runtime.py", "core/worker_main.py",
    "core/accelerators.py", "core/serialization.py", "serve/proxy.py",
    "serve/router.py", "serve/replica.py", "serve/controller.py",
    "serve/request_ledger.py", "util/tracing.py", "util/httpd.py",
    "metrics/registry.py", "shm/__init__.py",
    "parallel/collectives.py", "parallel/mesh.py", "parallel/sharding.py",
    "parallel/ring_attention.py", "util/collective.py",
    "train/trainer.py", "train/backend.py", "train/session.py",
    "train/cuda_utils.py", "train/sharded_checkpoint.py",
    "train/worker_group.py", "train/torch.py", "train/huggingface.py",
    "dag/__init__.py", "dag/channel.py", "dag/compiled_dag.py",
    "dag/dag_node.py", "dag/execution.py", "parallel/moe.py",
    "parallel/pipeline.py", "parallel/pipeline_dag.py", "models/mixtral.py",
    "data/__init__.py", "data/block.py", "data/context.py",
    "data/aggregate.py", "data/plan.py", "data/datasource.py",
    "data/tfrecord.py", "data/avro.py", "data/executor.py",
    "data/shuffle.py", "data/iterator.py", "data/dataset.py",
    "tune/__init__.py", "tune/search.py", "tune/schedulers.py",
    "tune/trainable.py", "tune/controller.py", "tune/tuner.py",
    "rllib/__init__.py", "rllib/bench.py", "rllib/connectors.py",
    "rllib/core/__init__.py", "rllib/core/rl_module.py",
    "rllib/core/learner.py", "rllib/algorithms/__init__.py",
    "rllib/algorithms/algorithm.py", "rllib/algorithms/algorithm_config.py",
    "rllib/algorithms/ppo.py", "rllib/env/__init__.py", "rllib/env/envs.py",
    "rllib/env/env_runner.py", "rllib/env/env_runner_group.py",
    "rllib/algorithms/appo.py", "rllib/algorithms/impala.py",
    "rllib/algorithms/dqn.py", "rllib/algorithms/sac.py",
    "rllib/algorithms/cql.py", "rllib/algorithms/bc.py",
    "rllib/algorithms/marwil.py", "rllib/env/multi_agent.py",
    "rllib/algorithms/multi_agent_ppo.py", "rllib/algorithms/dreamer.py",
    "examples/ppo_pixels.py", "examples/mnist.py", "testing.py",
    "cluster_utils.py",
    "job/__init__.py", "job/api.py", "workflow/__init__.py",
    "workflow/api.py", "util/state/__init__.py", "dashboard/__init__.py",
    "dashboard/timeline.py", "dashboard/grafana.py", "dashboard/head.py",
    "autoscaler/__init__.py", "autoscaler/node_provider.py",
    "autoscaler/command_runner.py", "autoscaler/autoscaler.py",
    "autoscaler/v2.py", "autoscaler/gke.py",
    "scripts/cli.py", "autoscaler/gcp.py", "autoscaler/commands.py",
    "util/accelerators.py", "util/multiprocessing/__init__.py",
    "util/multiprocessing/pool.py", "util/joblib/__init__.py",
    "util/joblib/ray_backend.py", "lint/__init__.py", "lint/__main__.py",
    "lint/framework.py", "lint/checks.py", "lint/concurrency.py",
    "lint/jscheck.py", "scripts/perf.py", "dryrun.py",
)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_sources_import_no_jax_and_nothing_of_ray_tpu():
    files = _port_files()
    assert len(files) >= 80  # the slices' modules are all scanned
    assert REPO / "ray_tpu_torch" / "ops" / "xent_pallas.py" in files
    for rel in RUNTIME_MODULES:
        assert REPO / "ray_tpu_torch" / rel in files, rel
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_kernel_sources_include_nothing_of_jax_or_ray_tpu():
    sources = sorted((REPO / "ray_tpu_torch" / "ops" / "csrc").glob("*.cu"))
    assert {s.name for s in sources} >= {"attention.cu", "paged_attention.cu",
                                         "xent.cu"}
    sources.append(REPO / "ray_tpu_torch" / "shm" / "shmstore.cc")
    bad = [f"{s.name}: {line.strip()}" for s in sources
           for line in s.read_text().splitlines()
           if line.startswith("#include") and any(
               name in line for name in FORBIDDEN)]
    assert not bad, "\n".join(bad)


def test_cross_entropy_ops_run_with_jax_and_ray_tpu_blocked(tmp_path):
    """A fresh interpreter where importing jax or ray_tpu fails imports
    the fused cross entropy ops and runs both on CPU tensors against
    the materialising oracle."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        import torch
        from ray_tpu_torch.ops import fused_cross_entropy, pallas_cross_entropy
        from ray_tpu_torch.ops.xent_pallas import reference_cross_entropy
        gen = torch.Generator().manual_seed(0)
        x = torch.randn((24, 16), generator=gen)
        w = torch.randn((40, 16), generator=gen) * 0.1
        t = torch.randint(0, 40, (24,), generator=gen)
        want = reference_cross_entropy(x, w, t)
        for fn in (pallas_cross_entropy, fused_cross_entropy):
            torch.testing.assert_close(fn(x, w, t), want)
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_parallel_and_train_planes_run_with_jax_and_ray_tpu_blocked(
        tmp_path):
    """A fresh interpreter where importing jax or ray_tpu fails imports
    `parallel/` and `train/` (with `cuda_utils`, the sharded checkpoint
    and the LoRA trainer's loop), lays out a mesh, maps logical axes to
    placements, and writes and reads a sharded checkpoint."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        import torch
        import ray_tpu_torch.parallel as par
        import ray_tpu_torch.train as train
        from ray_tpu_torch.parallel import collectives
        from ray_tpu_torch.parallel.ring_attention import select_attention
        from ray_tpu_torch.scripts import train_llama_lora
        from ray_tpu_torch.train import cuda_utils, huggingface
        from ray_tpu_torch.train.sharded_checkpoint import (
            load_sharded, save_sharded)
        from ray_tpu_torch.util import collective
        assert par.MeshSpec(dp=2, tp=2).rank_array(range(4)).shape == (
            2, 1, 1, 1, 1, 2)
        assert [p.is_shard() for p in par.spec_from_logical(
            ("vocab", "embed"))] == [False, True, False, False, False, True]
        g = {{"w": torch.ones(3)}}
        assert cuda_utils.sync_gradients(g) is g
        save_sharded({{"w": torch.arange(4.0), "n": 2}}, {str(tmp_path)!r})
        out = load_sharded({str(tmp_path)!r}, {{"w": torch.zeros(4), "n": 0}})
        assert torch.equal(out["w"], torch.arange(4.0)) and out["n"] == 2
        assert train.CudaTrainer and collective.allreduce
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_dryrun_runs_with_jax_and_ray_tpu_blocked(tmp_path):
    """A fresh interpreter where importing jax, ray_tpu or the
    reference's `__graft_entry__` fails runs the port's dry run on a
    one-rank gloo world (`dryrun_multichip(1)`: the GPT-2 step alone),
    and `entry()` refuses to run without a card unless given the CPU."""
    code = textwrap.dedent(f"""
        import datetime, sys
        sys.path.insert(0, {str(REPO)!r})
        for name in {FORBIDDEN!r} + ("__graft_entry__",):
            sys.modules[name] = None
        import torch
        import torch.distributed as dist
        from ray_tpu_torch import dryrun
        # one rank: its store takes any free port
        dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=60))
        out = dryrun.dryrun_multichip(1, device="cpu", dtype=torch.float32)
        dist.destroy_process_group()
        assert out["mesh"] == {{"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}}
        assert out["gpt2_loss"] > 0 and out["pp_out"] is None
        if not torch.cuda.is_available():
            try:
                dryrun.entry()
            except RuntimeError:
                pass
            else:
                raise AssertionError("entry() ran without a card")
        assert not any(m.split(".")[0] in {FORBIDDEN!r} + ("__graft_entry__",)
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "OK", proc.stdout


def test_experts_pipelines_and_dag_run_with_jax_and_ray_tpu_blocked(
        tmp_path):
    """A fresh interpreter where importing jax or ray_tpu fails imports
    `dag/`, `parallel/moe.py`, `parallel/pipeline.py`,
    `parallel/pipeline_dag.py` and `models/mixtral.py` (and the expert
    and pipeline names of `parallel/`), runs a tiny Mixtral loss and a
    MoE layer on the CPU, and carries torch tensors (bf16 included)
    through the channel's codec."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        import torch
        import ray_tpu_torch.dag as dag
        from ray_tpu_torch.dag import channel
        from ray_tpu_torch.models import mixtral
        from ray_tpu_torch.parallel import (
            CompiledPipeline, MoEConfig, bubble_fraction, compile_pipeline,
            init_moe, moe_forward, one_f1b_schedule, pipeline_apply,
            stage_sharding)
        cfg = mixtral.MixtralConfig.tiny(vocab_size=32)
        params = mixtral.init_params(cfg, 0, device="cpu")
        toks = torch.randint(0, 32, (2, 9),
                             generator=torch.Generator().manual_seed(0))
        loss, metrics = mixtral.loss_fn(cfg, params, toks)
        assert torch.isfinite(loss)
        mcfg = MoEConfig(dim=8, hidden=16, num_experts=4,
                         dtype=torch.float32)
        out, aux = moe_forward(mcfg, init_moe(mcfg, 0, device="cpu"),
                               torch.ones(2, 3, 8))
        assert out.shape == (2, 3, 8)
        x = {{"a": torch.arange(6.0).bfloat16(), "b": torch.ones(2, 2)}}
        chunks, _ = channel.encode_tensors(x)
        got, _ = channel.decode_tensors(memoryview(b"".join(
            bytes(memoryview(c).cast("B")) for c in chunks)))
        assert all(torch.equal(got[k], v) for k, v in x.items())
        assert got["a"].dtype == torch.bfloat16
        assert one_f1b_schedule(0, 2, 2) and bubble_fraction(2, 2) == 1 / 3
        assert dag.InputNode and CompiledPipeline and compile_pipeline
        assert pipeline_apply and stage_sharding
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_engine_serves_with_jax_and_ray_tpu_blocked(tmp_path):
    """A fresh interpreter where importing jax or ray_tpu fails still
    imports the engine and serves a tiny CPU request."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        for name in {FORBIDDEN!r}:
            sys.modules[name] = None
        import torch
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.serve.llm_engine import LlamaEngine
        cfg = llama.LlamaConfig.tiny(vocab_size=64)
        params = llama.init_params(cfg, 0, device="cpu")
        eng = LlamaEngine(cfg, params, slots=2, chunk=2, block_size=8,
                          max_len=32, device="cpu")
        try:
            out = eng.submit([1, 2, 3], 4).result(timeout=60)
        finally:
            eng.shutdown()
        want = llama.generate(cfg, params, [[1, 2, 3]], 4, device="cpu")
        assert out == want[0].tolist(), (out, want)
        assert not any(m.split(".")[0] in {FORBIDDEN!r}
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK", out)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_runtime_modules_do_not_import_torch():
    """Node daemons and workers import the package, the runtime, the
    serve plane, the train plane (a train worker actor), the compiled
    graphs (an exec loop, a pipeline stage), data (read, map and
    shuffle tasks, the split coordinator) and tune (a trial actor);
    none of that imports torch (resolve_device and the feed onto the
    card import it when called).  Nor does the operations plane (a job
    supervisor, the workflow executor, the dashboard actor, the state
    API, the autoscaler), nor the command line, the cluster launcher,
    the user utilities a pool worker or a joblib batch runs, rtlint,
    or the perf harness (its engine rows import torch when they run)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import ray_tpu_torch
        import ray_tpu_torch.core.noded
        import ray_tpu_torch.core.worker_main
        import ray_tpu_torch.serve
        import ray_tpu_torch.serve.schema
        import ray_tpu_torch.train
        import ray_tpu_torch.parallel
        import ray_tpu_torch.parallel.pipeline_dag
        import ray_tpu_torch.dag
        import ray_tpu_torch.dag.execution
        import ray_tpu_torch.util.collective
        import ray_tpu_torch.data
        import ray_tpu_torch.data.shuffle
        import ray_tpu_torch.data.tfrecord
        import ray_tpu_torch.data.avro
        import ray_tpu_torch.tune
        import ray_tpu_torch.tune.controller
        import ray_tpu_torch.testing
        import ray_tpu_torch.cluster_utils
        import ray_tpu_torch.job
        import ray_tpu_torch.workflow
        import ray_tpu_torch.util.state
        import ray_tpu_torch.dashboard
        import ray_tpu_torch.dashboard.grafana
        import ray_tpu_torch.dashboard.timeline
        import ray_tpu_torch.autoscaler
        import ray_tpu_torch.autoscaler.command_runner
        import ray_tpu_torch.scripts.cli
        import ray_tpu_torch.autoscaler.gcp
        import ray_tpu_torch.autoscaler.commands
        import ray_tpu_torch.util.accelerators
        import ray_tpu_torch.util.multiprocessing
        import ray_tpu_torch.util.joblib
        import ray_tpu_torch.lint
        import ray_tpu_torch.lint.checks
        import ray_tpu_torch.lint.concurrency
        import ray_tpu_torch.lint.jscheck
        import ray_tpu_torch.scripts.perf
        bad = sorted(m for m in sys.modules if m.split(".")[0] == "torch")
        assert not bad, bad
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_runtime_serves_http_with_jax_and_ray_tpu_blocked(tmp_path):
    """A driver, its node daemon and every worker run with `jax` and
    `ray_tpu` replaced by modules that refuse to import (and leave a
    mark when something tries): the port's runtime boots, deploys a
    tiny CPU ContinuousLlamaService and answers over HTTP with
    `generate`'s tokens, and nothing tried to import the blocked
    packages."""
    block = tmp_path / "block"
    block.mkdir()
    marks = tmp_path / "marks"
    marks.mkdir()
    for name in FORBIDDEN:
        (block / f"{name}.py").write_text(textwrap.dedent(f"""
            import os
            open(os.path.join({str(marks)!r}, "{name}." + str(os.getpid())),
                 "w").close()
            raise ImportError("{name} is blocked for this run")
        """))
    code = textwrap.dedent(f"""
        import json, sys, urllib.request
        import ray_tpu_torch as rt
        from ray_tpu_torch import serve
        from ray_tpu_torch.examples.serve_llm import (
            ContinuousLlamaService, _build_model)
        from ray_tpu_torch.models import llama
        rt.init(num_workers=2, num_cpus=8)
        try:
            app = ContinuousLlamaService.options(
                health_check_timeout_s=120).bind(
                model_size="tiny", max_new_tokens=4, slots=2, chunk=2,
                max_len=32, block_size=8, device="cpu")
            serve.run(app, name="iso", route_prefix="/iso", timeout_s=150)
            host, port = serve.http_address()
            req = urllib.request.Request(
                f"http://{{host}}:{{port}}/iso",
                data=json.dumps({{"tokens": [[5, 6, 7]],
                                 "max_new_tokens": 4}}).encode(),
                headers={{"Content-Type": "application/json"}})
            with urllib.request.urlopen(req, timeout=120) as resp:
                got = json.loads(resp.read())["tokens"]
        finally:
            serve.shutdown()
            rt.shutdown()
        cfg, params = _build_model("tiny", 0, device="cpu")
        want = llama.generate(cfg, params, [[5, 6, 7]], 4, device="cpu")
        assert got == want.tolist(), (got, want)
        print("OK", got)
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RT_", "RTT_"))}
    env["PYTHONPATH"] = f"{block}{os.pathsep}{REPO}"
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
    assert not sorted(p.name for p in marks.iterdir())


def test_data_and_tune_run_with_jax_and_ray_tpu_blocked(tmp_path):
    """A driver, its node daemon and every worker run with `jax` and
    `ray_tpu` replaced by modules that refuse to import: a shuffled,
    sorted dataset reaches the driver through `iter_cuda_batches` on
    the CPU, and a `Tuner` runs a grid of two trials, with nothing
    trying to import the blocked packages."""
    block = tmp_path / "block"
    block.mkdir()
    marks = tmp_path / "marks"
    marks.mkdir()
    for name in FORBIDDEN:
        (block / f"{name}.py").write_text(textwrap.dedent(f"""
            import os
            open(os.path.join({str(marks)!r}, "{name}." + str(os.getpid())),
                 "w").close()
            raise ImportError("{name} is blocked for this run")
        """))
    code = textwrap.dedent("""
        import ray_tpu_torch as rt
        from ray_tpu_torch import data as rd
        from ray_tpu_torch import tune
        rt.init(num_workers=2, num_cpus=4)
        try:
            ds = (rd.range(64, parallelism=4)
                  .map_batches(lambda b: {"id": b["id"], "sq": b["id"] ** 2})
                  .random_shuffle(seed=0).sort("id"))
            got = [b["sq"].tolist()
                   for b in ds.iter_cuda_batches(batch_size=16, device="cpu")]
            assert sum(got, []) == [i * i for i in range(64)], got

            def objective(config):
                tune.report({"score": config["x"] * 2})

            grid = tune.Tuner(objective, param_space={
                "x": tune.grid_search([1, 3])}).fit()
            assert grid.num_errors == 0
            assert grid.get_best_result("score", "max").metrics["score"] == 6
        finally:
            rt.shutdown()
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RT_", "RTT_"))}
    env["PYTHONPATH"] = f"{block}{os.pathsep}{REPO}"
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
    assert not sorted(p.name for p in marks.iterdir())


def test_ops_plane_runs_with_jax_and_ray_tpu_blocked(tmp_path):
    """A driver, its node daemons and every worker run with `jax` and
    `ray_tpu` replaced by modules that refuse to import: a job runs to
    SUCCEEDED, a workflow fails, resumes and returns, the dashboard
    serves its SPA and a timeline equal to `timeline()`'s, and
    `AutoscalerV2` over the local provider scales a `{"GPU": 1}` node
    up for a `num_gpus=1` task, with nothing trying to import the
    blocked packages."""
    block = tmp_path / "block"
    block.mkdir()
    marks = tmp_path / "marks"
    marks.mkdir()
    for name in FORBIDDEN:
        (block / f"{name}.py").write_text(textwrap.dedent(f"""
            import os
            open(os.path.join({str(marks)!r}, "{name}." + str(os.getpid())),
                 "w").close()
            raise ImportError("{name} is blocked for this run")
        """))
    code = textwrap.dedent(f"""
        import json, os, sys, time, urllib.request
        import ray_tpu_torch as rt
        from ray_tpu_torch import job, workflow
        from ray_tpu_torch.autoscaler import (
            AutoscalerV2, AutoscalerV2Config, LocalNodeProvider,
            NodeTypeConfigV2)
        from ray_tpu_torch.dashboard import start_dashboard
        from ray_tpu_torch.util import state

        info = rt.init(num_workers=2, num_cpus=4, num_gpus=0)
        provider = None
        try:
            jid = job.submit_job(sys.executable + " -c 'print(6 * 7)'")
            assert job.wait_job(jid, timeout=60) == "SUCCEEDED"
            assert "42" in job.get_job_logs(jid)

            workflow.init_storage({str(tmp_path / "wf")!r})
            flag = {str(tmp_path / "flag")!r}
            open(flag, "w").close()

            @rt.remote
            def double(x):
                return 2 * x

            @rt.remote
            def report(y, flag):
                if os.path.exists(flag):
                    raise RuntimeError("injected")
                return y + 1

            try:
                workflow.run(report.bind(double.bind(20), flag),
                             workflow_id="iso")
                raise AssertionError("expected the injected failure")
            except Exception as e:
                assert "injected" in str(e), e
            os.remove(flag)
            assert workflow.resume("iso") == 41

            head, (host, port) = start_dashboard()
            base = f"http://{{host}}:{{port}}"
            page = urllib.request.urlopen(base + "/", timeout=15).read()
            assert b"drawTimeline" in page
            for _ in range(100):
                doc = json.loads(urllib.request.urlopen(
                    base + "/api/timeline", timeout=15).read())
                done = {{e["name"] for e in doc["traceEvents"]
                        if e["ph"] == "X"}}
                if ({{"double", "report"}} <= done
                        and doc["traceEvents"] == rt.timeline()):
                    break
                time.sleep(0.2)
            else:
                raise AssertionError("the timeline never settled")
            assert state.summarize_tasks().get("FINISHED", 0) >= 2

            provider = LocalNodeProvider(info["controller_addr"])
            a = AutoscalerV2(provider, AutoscalerV2Config(
                node_types={{"gpu_worker": NodeTypeConfigV2(
                    num_cpus=2, resources={{"GPU": 1}}, num_workers=1,
                    max_slices=1)}}, max_hosts=1, idle_timeout_s=60))

            @rt.remote(num_gpus=1)
            def on_gpu_node():
                return 7

            ref = on_gpu_node.remote()
            deadline = time.time() + 90
            while time.time() < deadline:
                a.update()
                done, _ = rt.wait([ref], timeout=0.5)
                if done:
                    break
            assert rt.get(ref, timeout=30) == 7
            assert len(provider.non_terminated_nodes()) == 1
        finally:
            if provider is not None:
                for pid in provider.non_terminated_nodes():
                    provider.terminate_node(pid)
            rt.shutdown()
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RT_", "RTT_"))}
    env["PYTHONPATH"] = f"{block}{os.pathsep}{REPO}"
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK")
    assert not sorted(p.name for p in marks.iterdir())


def test_cli_launcher_and_lint_run_with_jax_and_ray_tpu_blocked(tmp_path):
    """With `jax` and `ray_tpu` replaced by modules that refuse to
    import, the command line answers `--help`, dry-runs `up` on a GPU
    cluster YAML, lints a file, and reads a live port cluster's
    `status` and `memory`, and a GPU pool's workers run a map; nothing
    tries to import the blocked packages, in any process."""
    import yaml

    block = tmp_path / "block"
    block.mkdir()
    marks = tmp_path / "marks"
    marks.mkdir()
    for name in FORBIDDEN:
        (block / f"{name}.py").write_text(textwrap.dedent(f"""
            import os
            open(os.path.join({str(marks)!r}, "{name}." + str(os.getpid())),
                 "w").close()
            raise ImportError("{name} is blocked for this run")
        """))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RT_", "RTT_"))}
    env["PYTHONPATH"] = f"{block}{os.pathsep}{REPO}"

    def run(*args, timeout=120):
        proc = subprocess.run([sys.executable, *args], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=timeout)
        assert proc.returncode == 0, (args, proc.stdout + proc.stderr)
        return proc.stdout

    cli = ("-m", "ray_tpu_torch.scripts.cli")
    assert "usage:" in run(*cli, "--help")
    cfg = tmp_path / "gpu.yaml"
    cfg.write_text(yaml.safe_dump({
        "cluster_name": "iso", "min_workers": 1,
        "provider": {"type": "gcp_gpu", "project": "p",
                     "zone": "us-central1-a", "machine_type": "a3-highgpu-8g"},
        "head": {"controller_host": "10.0.0.2"}}))
    out = run(*cli, "up", str(cfg), "--dry-run")
    assert out.count("DRY-RUN POST https://compute.googleapis.com/") == 2
    (tmp_path / "mod.py").write_text("x = 1\n")
    assert "0 finding(s)" in run("-m", "ray_tpu_torch.lint", "--no-baseline",
                                 str(tmp_path / "mod.py"))
    code = textwrap.dedent(f"""
        import json, os, subprocess, sys
        import ray_tpu_torch as rt
        import ray_tpu_torch.api as api
        from ray_tpu_torch.util.multiprocessing import Pool

        rt.init(num_workers=2, num_cpus=4, num_gpus=1)
        try:
            ready = os.path.join(api._session["session_dir"], "ready.json")
            big = rt.put(b"x" * (1 << 20))
            for cmd in (["status"], ["memory", "--json"]):
                out = subprocess.run(
                    [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
                     "--address", ready, *cmd], capture_output=True,
                    text=True, timeout=120, check=True).stdout
                assert json.loads(out), cmd

            def sq(x):
                return x * x

            with Pool(2, ray_remote_args={{"num_gpus": 0.5}}) as p:
                assert p.map(sq, range(6)) == [i * i for i in range(6)]
        finally:
            rt.shutdown()
        print("OK")
    """)
    assert run("-c", code, timeout=240).startswith("OK")
    assert not sorted(p.name for p in marks.iterdir())


def test_perf_harness_runs_with_jax_and_ray_tpu_blocked(tmp_path):
    """With `jax` and `ray_tpu` replaced by modules that refuse to
    import, the perf harness answers `--help`, measures a runtime row
    (a port cluster's daemon and workers) and the decode rows on the
    CPU; nothing tries to import the blocked packages, in any process."""
    block = tmp_path / "block"
    block.mkdir()
    marks = tmp_path / "marks"
    marks.mkdir()
    for name in FORBIDDEN:
        (block / f"{name}.py").write_text(textwrap.dedent(f"""
            import os
            open(os.path.join({str(marks)!r}, "{name}." + str(os.getpid())),
                 "w").close()
            raise ImportError("{name} is blocked for this run")
        """))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("RT_", "RTT_"))}
    env["PYTHONPATH"] = f"{block}{os.pathsep}{REPO}"

    def run(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.perf", *args],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=180)
        assert proc.returncode == 0, (args, proc.stdout + proc.stderr)
        return proc.stdout

    assert "--device" in run("--help")
    rows = run("--filter", "client tasks sync", "--rounds", "1",
               "--round-sec", "0.2", "--num-workers", "2")
    assert '"single client tasks sync"' in rows.splitlines()[-1]
    rows = run("--config", "decode_kernel", "--decode-batches", "2",
               "--device", "cpu")
    assert '"decode_b2_kernel"' in rows.splitlines()[-1]
    assert not sorted(p.name for p in marks.iterdir())


def test_rllib_runner_side_imports_no_torch_or_jax():
    """A runner actor's side of rllib loads with torch, jax and ray_tpu
    blocked: `rllib.env` (runners, environments, the group) and
    `rllib.connectors`, and with them the package, its modules and its
    algorithms (a runner unpickles module objects and connector
    factories).  A CartPole runner there samples a rollout through an
    `MLPModule`'s numpy forward, and a frame stack stacks; DQN's
    epsilon-greedy `QMLPModule`, discrete SAC's policy and continuous
    SAC's squashed Gaussian act through their numpy paths, and the
    offline readers and v-trace run; a multi-agent runner samples the
    coordination game a module a policy, DreamerV3's runner policy
    (`_DreamerPolicy`) acts, and the examples load, all without
    torch."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        for name in {FORBIDDEN + ("torch",)!r}:
            sys.modules[name] = None
        import numpy as np
        import ray_tpu_torch.rllib.connectors
        import ray_tpu_torch.rllib.env
        from ray_tpu_torch.rllib import PPOConfig, bench
        from ray_tpu_torch.rllib.connectors import FrameStack
        from ray_tpu_torch.rllib.core.rl_module import MLPModule
        from ray_tpu_torch.rllib.env import EnvRunner
        runner = EnvRunner("CartPole-v1", 2, 8, seed=0)
        tower = lambda n: [{{"w": np.full((4, n), 0.1, np.float32),
                             "b": np.zeros(n, np.float32)}}]
        runner.set_weights({{"pi": tower(2), "vf": tower(1)}}, 1)
        batch = runner.sample(MLPModule(4, 2, hidden=()))
        assert batch["obs"].shape == (8, 2, 4), batch["obs"].shape
        assert np.isfinite(batch["logp"]).all()
        stacked = FrameStack(4).on_observations(np.ones((2, 3, 3, 1)))
        assert stacked.shape == (2, 3, 3, 4)
        assert PPOConfig and bench.measure_rllib_ppo
        from ray_tpu_torch.rllib import (
            APPOConfig, BCConfig, CQLConfig, DQNConfig, IMPALAConfig,
            MARWILConfig, SACConfig)
        from ray_tpu_torch.rllib.algorithms import appo, cql, marwil
        from ray_tpu_torch.rllib.algorithms.dqn import (
            QMLPModule, ReplayBuffer, _transitions)
        from ray_tpu_torch.rllib.algorithms.sac import (
            ContinuousSACModule, SACModule)
        rng = np.random.default_rng(0)
        obs = batch["obs"][0]
        q_tower = lambda n, i=4: [{{"w": np.full((i, n), 0.1, np.float32),
                                   "b": np.zeros(n, np.float32)}}]
        act, _, _ = QMLPModule(4, 2, hidden=()).select_actions_numpy(
            {{"pi": q_tower(2), "vf": q_tower(1)}}, obs, rng, 0.5)
        assert act.shape == (2,)
        logits, _ = SACModule(4, 2, hidden=()).forward_numpy(
            {{"pi": q_tower(2)}}, obs)
        assert logits.shape == (2, 2)
        a, logp, _ = ContinuousSACModule(4, 1, hidden=()).select_actions_numpy(
            {{"pi": q_tower(2)}}, obs, rng, True)
        assert a.shape == (2, 1) and np.isfinite(logp).all()
        buf = ReplayBuffer(16, 4)
        buf.add_batch(*_transitions(batch))
        assert buf.sample(4, rng)["obs"].shape == (4, 4)
        adv, vs = appo.compute_vtrace(
            batch["logp"], batch["logp"], batch["rewards"],
            np.zeros((8, 2), np.float32), np.zeros(2, np.float32),
            batch["terminated"], batch["truncated"],
            np.zeros((8, 2), np.float32), 0.99)
        assert vs.shape == (8, 2)
        assert marwil.discounted_returns(np.ones(3), np.zeros(3), 0.5)[0] == 1.75
        assert cql._load_dataset({{k: np.zeros(2) for k in (
            "obs", "actions", "rewards", "next_obs", "terminated")}})
        assert (APPOConfig and BCConfig and CQLConfig and DQNConfig
                and IMPALAConfig and MARWILConfig and SACConfig)
        import types
        from ray_tpu_torch.examples import mnist, ppo_pixels
        from ray_tpu_torch.rllib import DreamerConfig, MultiAgentPPOConfig
        from ray_tpu_torch.rllib.algorithms.dreamer import (
            DreamerModel, _DreamerPolicy)
        from ray_tpu_torch.rllib.env.multi_agent import (
            MultiAgentEnvRunner, multi_agent_gae)
        ma = MultiAgentEnvRunner("coordination", 12,
                                 {{"agent_0": "a", "agent_1": "b"}}, seed=0)
        ma.set_weights({{m: {{"pi": q_tower(2, 2), "vf": q_tower(1, 2)}}
                        for m in "ab"}}, 1)
        out = ma.sample({{m: MLPModule(2, 2, hidden=()) for m in "ab"}})
        assert out["a"]["obs"].shape == (12, 2)
        adv, _ = multi_agent_gae(out["b"], 0.99, 0.95)
        assert np.isfinite(adv).all()
        cfg = DreamerConfig()
        cfg.deter_size, cfg.stoch_groups, cfg.stoch_classes = 8, 2, 2
        cfg.embed_hidden = cfg.head_hidden = (8,)
        policy = _DreamerPolicy(types.SimpleNamespace(
            model=DreamerModel(cfg, 4, 2)))
        layer = lambda m, n: {{"w": np.full((m, n), 0.1, np.float32),
                              "b": np.zeros(n, np.float32)}}
        logits, _ = policy.forward_numpy(
            {{"wm": {{"encoder": [layer(4, 8)],
                     "posterior": [layer(16, 8), layer(8, 4)]}},
              "actor": [layer(12, 8), layer(8, 2)]}}, obs)
        assert logits.shape == (2, 2) and np.isfinite(logits).all()
        assert MultiAgentPPOConfig and mnist.make_dataset and ppo_pixels.run
        assert not any(m.split(".")[0] in {FORBIDDEN + ("torch",)!r}
                       for m, mod in sys.modules.items() if mod is not None)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


def test_entry_points_raise_without_a_card(no_card):
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.examples.serve_llm import _build_model
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.bridge import params_from_numpy
    from ray_tpu_torch.serve.llm_engine import LlamaEngine

    cfg = llama.LlamaConfig.tiny(vocab_size=64)
    params = llama.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        llama.generate(cfg, params, [[1, 2]], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"x": params["final_norm"].numpy()})
    with pytest.raises(RuntimeError, match="CUDA"):
        _build_model("tiny", seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_rllib_learners_raise_without_a_card(no_card):
    """Every algorithm's learner defaults to the card: its learner
    group raises without one unless `device="cpu"` is given; the offline
    algorithms (no runners), multi-agent PPO and DreamerV3 raise from
    `build()`, and both examples' `run()` raise."""
    from ray_tpu_torch.rllib import BCConfig, CQLConfig, MARWILConfig
    from ray_tpu_torch.rllib.algorithms import (
        appo, bc, cql, dqn, impala, marwil, sac)
    from ray_tpu_torch.rllib.core.learner import LearnerGroup
    from ray_tpu_torch.rllib.core.rl_module import MLPModule

    for module, loss in (
            (MLPModule(4, 2), appo.make_appo_loss(0.3, 0.5, 0.01)),
            (MLPModule(4, 2), impala.make_impala_loss(0.5, 0.01)),
            (dqn.QMLPModule(4, 2), dqn.make_dqn_loss()),
            (sac.SACModule(4, 2), sac.make_sac_loss(0.3)),
            (sac.ContinuousSACModule(4, 1), sac.make_continuous_sac_loss(-1)),
            (dqn.QMLPModule(4, 2), cql.make_cql_loss(1.0)),
            (MLPModule(4, 2), bc.bc_loss),
            (MLPModule(4, 2), marwil.make_marwil_loss(1.0, 1.0, 20.0))):
        with pytest.raises(RuntimeError, match="CUDA"):
            LearnerGroup(module, loss)
        assert LearnerGroup(module, loss, device="cpu").device == \
            torch.device("cpu")
    rng = np.random.default_rng(0)
    data = {"obs": rng.normal(size=(8, 4)).astype(np.float32),
            "next_obs": rng.normal(size=(8, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, 8).astype(np.int32),
            "rewards": np.ones(8, np.float32),
            "terminated": np.zeros(8, bool)}
    for cfg in (CQLConfig(), BCConfig(), MARWILConfig()):
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg.offline_data(input_=data).build()
    # multi-agent PPO's learner groups and DreamerV3's device raise at
    # setup, before any runner starts; the examples before anything
    from ray_tpu_torch.examples import mnist, ppo_pixels
    from ray_tpu_torch.rllib import DreamerConfig, MultiAgentPPOConfig

    for cfg in (MultiAgentPPOConfig(), DreamerConfig()):
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg.build()
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo_pixels.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        mnist.run()


def test_engine_refuses_params_on_another_device():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LlamaEngine

    cfg = llama.LlamaConfig.tiny(vocab_size=64)
    params = llama.init_params(cfg, 0, device="cpu")
    params = dict(params, tok_emb=params["tok_emb"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        LlamaEngine(cfg, params, device="cpu")
