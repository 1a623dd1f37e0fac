"""The port stands alone: nothing under src/repro_torch/ and nothing in
chip_smoke.py imports jax or the JAX package (``repro``), not even one of
its numpy-only modules."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/serving/engine.py" in names
    assert "chip_smoke.py" in names
    assert len(names) > 25


def test_the_engine_leaves_the_model_step_to_paged_model():
    """The serving engine schedules, fetches and stamps; the model step
    (``serving/paged_model.py``) is the only serving module that reaches
    into the models or the parameters."""
    path = ROOT / "src" / "repro_torch" / "serving" / "engine.py"
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names += [f"{node.module}.{a.name}" for a in node.names]
    assert "repro_torch.serving.paged_model" in names
    bad = [n for n in names if n.startswith(("repro_torch.models",
                                             "repro_torch.params"))]
    assert not bad, f"serving/engine.py imports {bad}"
