"""The harness is driven by data: a configuration, a mix, a metric and a
cell added as files only are taken by name, and every name in
BENCHMARK.json has its file."""
import json

import pytest

from kvbench import harness
from kvbench.tests import tiny

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")

NEW_METRIC = '''
def read(run):
    lo, hi = run.window
    return float(sum(len(r.req.token_times) for r in run.records))
'''


def test_a_cell_added_as_files_only_is_run(tmp_path):
    base = tmp_path / "kvbench"
    bench = tiny.write(base, tiny.DENSE, tiny.CHAT, cell="added.cell")
    (base / "metrics" / "tokens_served.py").write_text(NEW_METRIC)
    bench["end_to_end"].append({"name": "tokens_served", "unit": "tokens",
                                "workloads": ["added.cell"]})
    bench["end_to_end"].append({"name": "setup_s", "unit": "s",
                                "workloads": ["other.cell"]})
    res = tiny.run(base, bench, cell="added.cell", seconds=0.5)
    assert res["correct"] is True
    assert res["metrics"]["tokens_served"]["value"] > 0
    assert res["metrics"]["tokens_served"]["unit"] == "tokens"
    assert list(res)[-1] == "compared"
    assert res["compared"]["served_gap"]["limit"] == 1e-3


def test_a_cell_without_limits_is_not_correct(tmp_path):
    base = tmp_path / "kvbench"
    bench = tiny.write(base, tiny.DENSE, tiny.CHAT)
    (base / "limits" / "tiny.cell.json").unlink()
    res = tiny.run(base, bench, seconds=0.3)
    assert res["correct"] is False
    assert res["compared"]["served_gap"]["limit"] is None


def test_every_name_in_the_benchmark_has_its_file():
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert (harness.HERE / "reference"
                / f"{cfg['reference']}.py").exists()
        assert set(c["reduced"]) == set(cfg["reduced"])
    for w in BENCH["workloads"]:
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (harness.HERE / "limits" / f"{w['name']}.json").exists(), \
            w["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


def test_each_cell_reports_what_its_per_layer_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        names = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
        assert "setup_s" in names and len(names) >= 2
        assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("cfg", sorted(
    (harness.HERE / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_configuration_files_build_a_model_config(cfg):
    c = json.loads(cfg.read_text())
    m = harness.model_config(c)
    assert m.num_layers == c["model"]["num_layers"]
    from kvbench import weights
    assert weights.n_params(c["model"], c["weights"]) == c["parameters"]


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.\-]{1,16}$"


def test_benchmark_file_keeps_the_format():
    import re
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["kvbench"]
    assert (harness.ROOT / BENCH["command"][1]).is_relative_to(
        harness.ROOT / "kvbench")
    one_line = lambda s: 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.match(NAME, c["name"]) and one_line(c["why"])
        assert one_line(c["source"]) and c["file"].startswith("kvbench/")
        assert all(re.match(NAME, k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.match(NAME, w["name"]) and one_line(w["why"])
        assert w["chips"] == 1
    names = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(NAME, m["name"]) and re.match(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert one_line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024
