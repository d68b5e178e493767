"""BENCHMARK.json against the benchmark's files: every configuration, cell,
mix, entry and metric is found by name, and what the files say agrees."""
import json
import re

import pytest

from cobsbench.harness.spec import BENCH_DIR, CHECKOUT, Spec

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cobsbench"]
    assert BENCH["command"] == ["python3", "cobsbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"])
    assert c["file"] == f"cobsbench/configs/{c['name']}.json"
    cfg = Spec().config(c["name"])
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"]
    assert set(c["reduced"]) <= set(cfg["index"]) | set(cfg["corpus"])
    assert cfg["assumed"] and cfg["source"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    sp = Spec()
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    cell = sp.cell(w["name"])
    assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == \
        (w["config"], w["traffic"], w["chips"], w["why"])
    mix = sp.mix(w["traffic"])
    assert int(mix["chunk"]) >= 1 and int(mix["pool"]) >= 8 * int(mix["chunk"])
    assert callable(sp.entry(cell["entry"]).run)
    e2e = [m["name"] for m in sp.metrics_of(w["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert sp.metrics_of(w["name"], "per_layer")


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(m):
    mod = Spec().metric(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == \
        (m["unit"], m["layer"], m["moves"], m["source"])
    assert callable(mod.read)
    if m["name"].split(".")[0].endswith("_roofline"):
        assert m["unit"] == "%"


def test_every_file_is_used():
    """Each configuration, mix, entry and metric file under the benchmark
    is named by BENCHMARK.json or by a cell."""
    sp = Spec()
    cells = [sp.cell(w["name"]) for w in BENCH["workloads"]]
    used = {"configs": {c["name"] for c in BENCH["configs"]},
            "workloads": {w["name"] for w in BENCH["workloads"]},
            "traffic": {w["traffic"] for w in BENCH["workloads"]},
            "entries": {c["entry"] for c in cells},
            "metrics": {m["name"] for m in BENCH["per_layer"]}}
    for folder, names in used.items():
        found = {p.name.rsplit(".", 1)[0]
                 for p in (BENCH_DIR / folder).iterdir()
                 if p.suffix in (".json", ".py")}
        assert found == names, folder
