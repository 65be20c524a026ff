"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; top-level names compared
whole (`sat_tpu_torch` is not `sat_tpu`)."""

import ast
import subprocess
import sys

import pytest

from satbench import run, spec

FILES = sorted(p for p in spec.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_jax_in_any_file(path):
    assert not set(top_level_imports(path)) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    (spec.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "sat_tpu_torch" not in set(top_level_imports(path))
    assert not {m for m in top_level_imports(path)} - {
        "__future__", "contextlib", "math", "torch"}


def test_reference_loads_alone():
    code = ("import sys; import satbench.reference.model; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sat_tpu_torch', 'sat_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compared_whole(monkeypatch):
    fake = dict(sys.modules)
    for k in [k for k in fake if k.split(".")[0] in run.FORBIDDEN]:
        del fake[k]
    fake["sat_tpu_torch.models"] = None
    fake["jaxtyping"] = None
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["sat_tpu.ops"] = None
    fake["jaxlib"] = None
    assert run.forbidden_modules() == ["jaxlib", "sat_tpu"]
