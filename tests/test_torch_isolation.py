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


def test_zillow_without_a_compiler(tmp_path):
    """With no g++ on PATH the native module stays unloaded and Z1 runs on
    the Python path of the CSV source and the result decode."""
    script = tmp_path / "run.py"
    script.write_text(textwrap.dedent(f"""
        import tuplex_tpu_torch
        from tuplex_tpu_torch import native
        from tuplex_tpu_torch.models import zillow
        path = {str(tmp_path / "z.csv")!r}
        zillow.generate_csv(path, 300, seed=7)
        ctx = tuplex_tpu_torch.Context(device="cpu")
        got = zillow.build_pipeline(ctx.csv(path)).collect()
        print(native.get(), len(got) > 100,
              got == zillow.run_reference_python(path),
              ctx.metrics.stages[-1]["tier"], sum(native.calls.values()))
    """))
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(tmp_path / "empty"))
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines() == ["None True True compiled 0"]


def _aot_fixture_set(tree: ast.Module) -> bool:
    """An autouse fixture that sets TUPLEX_AOT_CACHE with monkeypatch."""
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        autouse = any(isinstance(d, ast.Call) and any(
            k.arg == "autouse" and getattr(k.value, "value", None) is True
            for k in d.keywords) for d in fn.decorator_list)
        sets = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "setenv"
            and getattr(n.func.value, "id", None) == "monkeypatch"
            and n.args and getattr(n.args[0], "value", None)
            == "TUPLEX_AOT_CACHE" for n in ast.walk(fn))
        if autouse and sets:
            return True
    return False


def test_reference_contexts_keep_off_the_shared_aot_store():
    """Every port test file that builds a `tuplex_tpu.Context` points the
    reference's AOT store at a directory of its own: the store under
    ~/.cache is shared by every process of one HOME, and a warm one breaks
    reference tests (ROADMAP C5)."""
    tests = os.path.join(REPO, "tests")
    checked = []
    for name in sorted(os.listdir(tests)):
        if not (name.startswith("test_torch_") and name.endswith(".py")):
            continue
        tree = ast.parse(open(os.path.join(tests, name)).read())
        builds = any(
            isinstance(n, ast.Attribute) and n.attr == "Context"
            and getattr(n.value, "id", None) == "tuplex_tpu"
            for n in ast.walk(tree)) or any(
            isinstance(n, ast.ImportFrom) and n.module == "tuplex_tpu"
            and any(a.name == "Context" for a in n.names)
            for n in ast.walk(tree))
        if builds:
            checked.append(name)
            assert _aot_fixture_set(tree), name
    assert {"test_torch_pipeline.py", "test_torch_faults.py"} <= set(checked)


def _wide_fixtures(tree: ast.Module):
    """Fixtures of module, package or session scope: they are set up
    before the function-scoped autouse fixtures of their file."""
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and any(
                isinstance(d, ast.Call) and any(
                    k.arg == "scope" and getattr(k.value, "value", None)
                    in ("module", "package", "session")
                    for k in d.keywords) for d in fn.decorator_list):
            yield fn


def test_wide_fixtures_set_their_own_aot_store():
    """A module-scoped fixture that runs a `tuplex_tpu.Context` runs
    before the autouse fixture that sets TUPLEX_AOT_CACHE, so it sets the
    store itself (it would otherwise warm the shared store under ~/.cache
    for every other worker, ROADMAP C5)."""
    tests = os.path.join(REPO, "tests")
    for name in sorted(os.listdir(tests)):
        if not (name.startswith("test_torch_") and name.endswith(".py")):
            continue
        tree = ast.parse(open(os.path.join(tests, name)).read())
        for fn in _wide_fixtures(tree):
            runs = any(isinstance(n, ast.Attribute) and n.attr == "Context"
                       and getattr(n.value, "id", None) == "tuplex_tpu"
                       for n in ast.walk(fn))
            sets = any(isinstance(n, ast.Call) and
                       isinstance(n.func, ast.Attribute) and
                       n.func.attr == "setenv" and n.args and
                       getattr(n.args[0], "value", None) == "TUPLEX_AOT_CACHE"
                       for n in ast.walk(fn))
            assert sets or not runs, f"{name}: fixture {fn.name}"


def test_package_imports_neither_jax_nor_reference():
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "torch_zillow_profile.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert os.path.join(PKG, "native", "__init__.py") in paths
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
