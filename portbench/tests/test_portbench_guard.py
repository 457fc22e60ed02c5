"""The import guard, and what the reference and the harness import."""
import ast
import os
import subprocess
import sys

import pytest

from conftest import PB, REPO

import guard  # noqa: E402


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "svtrek_tpu",
                                  "svtrek_tpu.ops", "jax.numpy"])
def test_guard_refuses(name):
    code = ("import sys; sys.path.insert(0, %r); import guard; "
            "guard.install()\ntry:\n    __import__(%r)\nexcept "
            "guard.RefusedImport:\n    print('refused')\n" % (PB, name))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "refused", out.stderr


def test_guard_passes_the_port():
    code = ("import sys; sys.path.insert(0, %r); import guard; "
            "guard.install(); import svtrek_tpu_torch.pipeline.audit; "
            "print(guard.loaded())" % PB)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["svtrek_tpu", "svtrek_tpu.x", "jax", "flax",
                                  "jaxlib.xla"])
def test_refused_names(name):
    assert guard.refused(name)


@pytest.mark.parametrize("name", ["svtrek_tpu_torch", "jaxtyping", "jax_x",
                                  "svtrek", "numpy"])
def test_allowed_names(name):
    assert not guard.refused(name)


def imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def py_files(*parts):
    root = os.path.join(PB, *parts)
    for d, _, files in os.walk(root):
        if "tests" in d.split(os.sep):
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("path", list(py_files("reference")))
def test_reference_imports_nothing_of_the_program(path):
    for name in imports(path):
        top = name.partition(".")[0]
        assert top not in ("svtrek_tpu_torch", "torch") and \
            not guard.refused(name), (path, name)


@pytest.mark.parametrize("path", list(py_files()))
def test_harness_imports_no_jax(path):
    for name in imports(path):
        assert not guard.refused(name), (path, name)
