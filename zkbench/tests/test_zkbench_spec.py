"""BENCHMARK.json against the contract's shape and the files it names,
and the loader finding a new cell, configuration, mix and metric by
name alone."""

import json
import re
import shutil

import pytest

from harness import session, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_names_and_lengths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(BENCH)) < 64 << 10


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(metric):
    mod = spec.load_module("metrics", metric["name"])
    assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
        metric["unit"], metric["layer"], metric["source"], metric["moves"])
    assert callable(mod.read)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_loads_and_reports_enough(cell):
    c = spec.load_cell(cell, BENCH)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert c.workload["chips"] == 1
    assert set(c.config["pcs"]) == {"pow_bits", "log_blowup",
                                    "log_last_layer", "n_queries",
                                    "log_arity"}
    job = spec.load_module("traffic", c.traffic["job"])
    machine = spec.load_module("machines", c.config["machine"])
    assert session.unread_keys(c, job, machine) == []
    cfg = {x["name"]: x for x in BENCH["configs"]}[c.workload["config"]]
    assert cfg["reduced"] == c.config["reduced"]
    assert cfg["source"] == c.config["source"]


def test_the_loader_finds_new_files_without_edits(tmp_path):
    root = tmp_path / "zkbench"
    shutil.copytree(spec.ROOT, root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__",
                                                  "reference"))
    (root / "configs" / "fib-new.json").write_text(json.dumps(
        dict(json.loads((root / "configs" / "fib-v1.json").read_text()),
             name="fib-new")))
    (root / "traffic" / "ladder20.json").write_text(json.dumps(
        dict(json.loads((root / "traffic" / "ladder.json").read_text()),
             rungs=[20])))
    (root / "metrics" / "new.metric.py").write_text(
        'UNIT, LAYER, SOURCE, MOVES = "s", "device", "program_span", '
        '"setup_s"\n\ndef read(ctx):\n    return 1.5\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "fib-new", "source": "x",
                             "file": "zkbench/configs/fib-new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "fib-new.ladder20",
                               "config": "fib-new", "traffic": "ladder20",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new.metric", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "device", "moves": "setup_s"})
    cell = spec.load_cell("fib-new.ladder20", bench, root)
    assert cell.traffic["rungs"] == [20] and cell.config["name"] == "fib-new"
    assert "new.metric" in [m["name"] for m in cell.per_layer]
    assert spec.load_module("metrics", "new.metric", root).read(None) == 1.5


@pytest.mark.parametrize("where, key, value", [
    ("traffic", "segment_log", 22), ("traffic", "clients", 4),
    ("config", "memory", "streamed")])
def test_a_key_nothing_reads_is_refused(where, key, value):
    c = spec.load_cell(BENCH["workloads"][0]["name"], BENCH)
    getattr(c, where)[key] = value
    with pytest.raises(ValueError, match=key):
        session.run(c, 1, 0, False, device="cpu", schedule=([], [10]))
