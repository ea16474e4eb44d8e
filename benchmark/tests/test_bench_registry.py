"""The harness finds a cell's configuration, mix and metrics by name, so a
later change adds one by files and entries alone."""

import json
import shutil

import pytest

from benchmark import harness, trace

ROOT = harness.ROOT


def test_every_cell_of_the_benchmark_resolves():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        assert harness.driver(cell.traffic["kind"]).Driver
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_a_config_mix_and_metric_added_as_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "benchmark/configs/gnerf-ffhq512.json").read_text())
    config["name"] = "gnerf-ffhq512-wide"
    (tmp_path / "benchmark/configs/gnerf-ffhq512-wide.json").write_text(json.dumps(config))
    (tmp_path / "benchmark/traffic/orbit-long.json").write_text(
        json.dumps({"kind": "orbit", "frames": 240, "photos": 8, "check_videos": 2}))
    (tmp_path / "benchmark/metrics/frames_seen.orbit-long.py").write_text(
        "def read(r):\n    return r['counters'].get('frames')\n")
    spec["configs"].append({"name": "gnerf-ffhq512-wide", "source": "https://example.org",
                            "file": "benchmark/configs/gnerf-ffhq512-wide.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "orbit-long", "config": "gnerf-ffhq512-wide",
                              "traffic": "orbit-long", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "frames_seen.orbit-long", "unit": "frames",
                              "better": "higher", "source": "program_counter", "layer": "x",
                              "moves": "frames_per_s", "workloads": ["orbit-long"]})
    spec["end_to_end"][0]["workloads"].append("orbit-long")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell("orbit-long", root=tmp_path)
    assert cell.config["name"] == "gnerf-ffhq512-wide"
    assert cell.traffic["frames"] == 240
    assert [m["name"] for m in cell.per_layer] == ["frames_seen.orbit-long"]
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "setup_s"}
    read = harness.reader("frames_seen.orbit-long", root=tmp_path)
    assert read({"counters": {"frames": 480}, "trace": trace.Trace(1.0, 1.0)}) == 480


def test_unknown_workload_exits():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such-cell")
