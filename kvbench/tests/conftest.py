"""The kvbench tests run from the repository root:
``python -m pytest -q kvbench/tests`` (the repository's own ``testpaths``
does not collect them).  Tests marked ``gpu`` need a CUDA card and skip
elsewhere."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
