"""Nothing the benchmark runs imports JAX, flax or the JAX package (compared
whole, by top-level name: the port's name begins with the JAX package's),
the reference imports nothing of the port, and nothing reads the JAX
package's benchmark (`benchmark/`, `bench.py`)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "stable_virtual_camera_tpu"}


def imported(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN
    text = path.read_text()
    assert "benchmark/" not in text and "bench.py" not in text


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((harness.HERE / "reference").rglob("*.py")):
        assert "stable_virtual_camera_tpu_torch" not in imported(path), path


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "stable_virtual_camera_tpu_torch_extra", sys)
    assert "stable_virtual_camera_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", "basic-768x576-pass1",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if out.returncode == 0:
        pytest.skip("a card is visible here")
    assert out.stdout.strip() == "" and "CUDA device" in out.stderr
