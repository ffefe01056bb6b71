"""Every configuration, cell and metric of BENCHMARK.json loads by name."""
import json
import os

import pytest

from bench_port import run

ROOT = run.ROOT


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cells():
    return [w["name"] for w in bench()["workloads"]]


@pytest.mark.parametrize("name", cells())
def test_cell_loads(name):
    cell, config, traffic, e2e, layer = run.load_cell(name)
    assert cell["name"] == name
    for folder, key in (("checks", config["check"]),
                        ("entries", config["entry"]),
                        ("generators", traffic["generator"])):
        assert os.path.isfile(os.path.join(ROOT, "bench_port", folder,
                                           key + ".py"))
    assert set(config["limits"]) and all(
        v is not None for v in config["limits"].values())
    assert traffic["jobs"] >= 1 and traffic["check_jobs"] >= 1
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"
    for m in e2e + layer:
        assert callable(run.reader(m["name"]))


def test_paths_and_names():
    b = bench()
    assert b["paths"] == ["bench_port"]
    assert b["command"][-1] == "bench_port/run.py"
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert cfg["corpus"][k] != cfg["published"][k]
        for k in set(cfg["corpus"]) & set(cfg.get("published", {})):
            assert k in c["reduced"] or \
                cfg["corpus"][k] == cfg["published"][k]
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells()
    for w in b["workloads"]:
        assert w["chips"] == 1
        assert os.path.isfile(os.path.join(
            ROOT, "bench_port", "traffic", w["traffic"] + ".json"))


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        run.load_cell("no-such-cell")
