"""Nothing under kvbench imports JAX, the JAX package or the old
benchmarks, and the reference imports nothing of the program: top-level
module names compared whole (``repro_torch`` begins with ``repro``)."""
import ast
import pathlib
import subprocess
import sys

import pytest

from kvbench import harness

FILES = sorted(harness.HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted(
    (harness.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert not names & {"repro_torch", "repro"}, names
    assert names <= {"__future__", "contextlib", "math", "typing", "torch",
                     "kvbench"}, names


def test_the_whole_is_by_top_level_name():
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_a_harness_process_loads_no_jax():
    code = ("import sys; sys.path[:0] = [{r!r}, {r!r} + '/src']\n"
            "from kvbench import harness, check, profile, readers\n"
            "from kvbench.reference import dense_gqa, deepseek_moe\n"
            "import repro_torch.serving.engine, repro_torch.cluster.storage\n"
            "print(harness.forbidden_modules())").format(
                r=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "yi-9b.doc_reuse", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and kvbench/, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "kvbench/run.py", "--workload", "yi-9b.doc_reuse",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
