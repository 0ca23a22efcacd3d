"""The port stands alone: `ray_tpu_torch` and `chip_smoke.py` import
neither JAX (nor its ecosystem) nor anything of `ray_tpu`, and the
port's entry points run on the card unless the caller asks for the
CPU — without a card they raise instead of carrying on silently.
"""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_files():
    files = sorted((REPO / "ray_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


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
    assert len(files) >= 14  # the slices' modules are all scanned
    assert REPO / "ray_tpu_torch" / "ops" / "xent_pallas.py" in files
    bad = [f"{f.relative_to(REPO)}:{line} imports {root}"
           for f in files for line, root in _imported_roots(f)
           if root in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_kernel_sources_include_nothing_of_jax_or_ray_tpu():
    sources = sorted((REPO / "ray_tpu_torch" / "ops" / "csrc").glob("*.cu"))
    assert {s.name for s in sources} >= {"attention.cu", "paged_attention.cu",
                                         "xent.cu"}
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


def test_engine_refuses_params_on_another_device():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.llm_engine import LlamaEngine

    cfg = llama.LlamaConfig.tiny(vocab_size=64)
    params = llama.init_params(cfg, 0, device="cpu")
    params = dict(params, tok_emb=params["tok_emb"].to("meta"))
    with pytest.raises(ValueError, match="params live on"):
        LlamaEngine(cfg, params, device="cpu")
