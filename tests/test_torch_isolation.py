"""tuplex_tpu_torch stands alone: it runs with `jax`, `tuplex_tpu` and
`pyarrow` blocked from import, and without CUDA it refuses to pick a device
unless the caller names the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tuplex_tpu_torch")


def test_smoke_pipeline_with_jax_blocked(tmp_path):
    script = tmp_path / "run.py"
    script.write_text(textwrap.dedent("""
        import sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "tuplex_tpu"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import tuplex_tpu_torch
        ctx = tuplex_tpu_torch.Context(device="cpu")
        ds = ctx.parallelize([1, 2, None, 4]).map(lambda x: (x, x * x))
        print(ds.collect(), ds.exception_counts(),
              ctx.metrics.interpreterRows())
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "tuplex_tpu")]
        print(sorted(loaded))
    """))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == [
        "[(1, 1), (2, 4), (4, 16)] {'TypeError': 1} 1", "[]"]


def test_zillow_csv_with_jax_and_pyarrow_blocked(tmp_path):
    """The CSV path needs no pyarrow: the GPU host has none."""
    script = tmp_path / "run.py"
    script.write_text(textwrap.dedent(f"""
        import sys

        BLOCKED = ("jax", "jaxlib", "tuplex_tpu", "pyarrow")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        import tuplex_tpu_torch
        from tuplex_tpu_torch.models import zillow
        path = {str(tmp_path / "z.csv")!r}
        zillow.generate_csv(path, 300, seed=7)
        ctx = tuplex_tpu_torch.Context(device="cpu")
        got = zillow.build_pipeline(ctx.csv(path)).collect()
        print(len(got) > 100, got == zillow.run_reference_python(path),
              ctx.metrics.stages[-1]["tier"])
        print(sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED))
    """))
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == ["True True compiled", "[]"]


def test_context_without_cuda_raises(monkeypatch):
    import torch

    import tuplex_tpu_torch
    from tuplex_tpu_torch.core.errors import TuplexException

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TuplexException, match="device='cpu'"):
        tuplex_tpu_torch.Context()
    with pytest.raises(TuplexException):
        tuplex_tpu_torch.Context(device="cuda")
    assert tuplex_tpu_torch.Context(device="cpu").device.type == "cpu"


def test_package_imports_neither_jax_nor_reference():
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "torch_zillow_profile.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "tuplex_tpu", "pyarrow"), (path, name)
