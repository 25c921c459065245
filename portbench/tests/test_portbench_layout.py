"""The harness finds every cell's configuration, traffic mix, limits and
metric readers by name, and BENCHMARK.json keeps to the benchmark's rules."""

import json
import re
from pathlib import Path

import pytest

from portbench import nets, readers, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    w, config = run.find(BENCH, cell)
    assert (ROOT / config["file"]).is_file()
    assert (run.PB / "traffic" / f"{w['traffic']}.json").is_file()
    limits = run.load_json(run.PB / "limits" / f"{cell}.json")["limits"]
    assert {"desc_gap", "score_gap", "stream_mismatch"} <= set(limits) <= {
        "desc_gap", "score_gap", "cand_gap", "edge_rot_deg", "edge_trans_m", "solve_gap",
        "stream_mismatch"}
    names = [n for n, _ in run.metric_names(BENCH, cell, False)]
    assert "setup_s" in names and len(names) >= 2
    assert run.metric_names(BENCH, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(readers.load(metric).read)


@pytest.mark.parametrize("path", sorted(readers.METRICS.glob("*.py")), ids=lambda p: p.stem)
def test_every_reader_file_loads(path):
    # the live cell's readers too, which BENCHMARK.json does not list yet
    assert callable(readers.load(path.stem).read)


def test_missing_reader_is_named():
    with pytest.raises(FileNotFoundError, match="no_such_metric"):
        readers.load("no_such_metric")


@pytest.mark.parametrize("name, file", [("device_idle.live", "device_idle.py"),
                                        ("step_mfu.live", "step_mfu.live.py"),
                                        ("k3_roofline.any_later_cell", "k3_roofline.py")])
def test_reader_of_a_cells_metric_falls_back_to_the_shared_one(name, file):
    assert readers.load(name).__file__ == str(readers.METRICS / file)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_names_its_cuts(config):
    c = next(c for c in BENCH["configs"] if c["name"] == config)
    f = json.loads((ROOT / c["file"]).read_text())
    assert sorted(c["reduced"]) == sorted(f["reduced"]) and c["source"] == f["source"]
    # the frames the rig renders are the frames the net describes
    assert f["rig"]["image_hw"] == f["cerebro_config"]["descriptor"]["image_hw"]


@pytest.mark.parametrize("path", sorted((run.PB / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_config_names_a_net_that_has_a_module(path):
    # the unlisted live configuration too
    f = json.loads(path.read_text())
    net = nets.load(f["net"])
    assert net.__file__ == str(nets.NETS / f"{f['net']}.py")
    weights = net.weights_dir(f, run.PB / "_cache")
    assert (weights / "params.npz").is_file()
    assert net.width(weights) > 0 and net.describe_flops(weights, f["rig"]["image_hw"]) > 0


def test_per_layer_metrics_only_where_their_end_to_end_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_contract_shapes():
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check must fit with 24 cells: 2 + 14 x cells runs
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"service", "describe", "detect", "verify", "pose graph", "kernels", "device"}
    assert all(w["chips"] == 1 for w in BENCH["workloads"]) and cells <= 24
    for text in [w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell, e2e, has, lacks", [
    ("bench_e2e_top3.relocalize", {"keyframes_per_s", "setup_s"}, "k2_roofline", "k1_roofline"),
])
def test_metrics_listing_by_trace(cell, e2e, has, lacks):
    assert {n for n, _ in run.metric_names(BENCH, cell, False)} == e2e
    per = {n for n, _ in run.metric_names(BENCH, cell, True)}
    assert has in per and lacks not in per
