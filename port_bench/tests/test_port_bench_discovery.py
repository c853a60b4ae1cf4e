"""BENCHMARK.json's cells, configurations, traffic mixes and metrics are
found by name, and the file keeps to the benchmark's contract."""

import json
import re

import pytest

from port_bench.harness import cell as cell_mod
from port_bench.harness import traffic as traffic_mod

BENCH = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert set(m.get("workloads", [])) <= set(WORKLOADS)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    cell = cell_mod.load_cell(workload)
    assert cell.config["scene"] and callable(cell_mod.entry_class(cell.traffic["entry"]))
    module = cell_mod.scene_module(cell.config["scene"])
    assert callable(module.build) and callable(module.transforms)
    stacks = cell_mod.stacks_of(cell)
    assert stacks.shape[0] == cell.traffic["path_frames"] and stacks.dtype.name == "float32"
    names = {m["name"] for m in cell.end_to_end}
    assert {"setup_s", "frames_per_s"} <= names
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        reader = cell_mod.load_module(cell_mod.BENCH_DIR / "metrics" / f"{m['name']}.py",
                                      f"probe_{m['name']}")
        assert callable(reader.read)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    data = traffic_mod.load(cell_mod.ROOT / config["file"])
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert 0 < data["check"]["off_share"] < 1


@pytest.mark.parametrize("config,traffic", [("strokes-1080p", "still"),
                                            ("showcase-4k", "orbit")])
def test_a_new_cell_is_a_traffic_file_and_an_entry(tmp_path, config, traffic):
    """A cell added by data alone: a BENCHMARK.json entry naming files that
    are there (a configuration that no cell uses yet among them) is found,
    with its entry module, without any code."""
    bench = dict(BENCH)
    files = {c["name"]: c for c in BENCH["configs"]}
    bench["configs"] = BENCH["configs"] + [
        {"name": config, "source": "probe", "file": f"port_bench/configs/{config}.json",
         "reduced": [], "why": "probe"}] * (config not in files)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": f"{config}.{traffic}", "config": config, "traffic": traffic,
         "chips": 1, "why": "probe"}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    (tmp_path / "port_bench").symlink_to(cell_mod.BENCH_DIR)
    cell = cell_mod.load_cell(f"{config}.{traffic}", bench_path=path)
    assert cell_mod.entry_class(cell.traffic["entry"]).__module__ == (
        f"port_bench.entries.{cell.traffic['entry']}")
    assert [m["name"] for m in cell.per_layer] == []
    assert cell_mod.stacks_of(cell).shape[0] == cell.traffic["path_frames"]


def test_configuration_options_pass_through_to_the_renderer():
    """Every key of a configuration's "configuration" and "renderer" reaches
    the port's Configuration and Renderer as it stands; the reference
    refuses what it does not render."""
    from port_bench.harness import port_lib
    from port_bench.reference import scene as ref

    config = {"width": 64, "height": 32,
              "configuration": {"msaa_sample_count": 8, "winding_counter_bits": 3,
                                "depth_compare": "less_equal", "depth_write_enabled": True},
              "renderer": {"strict_capacity": False, "auto_instance": False}}
    r = port_lib.renderer(config, "cpu")
    assert r.config.msaa_sample_count == 8
    assert r.config.depth_compare == "less_equal" and r.config.depth_write_enabled
    assert not r.auto_instance and not r.strict_capacity
    with pytest.raises(ValueError, match="depth_compare"):
        ref.frame_options(config["configuration"])
    assert ref.frame_options({"msaa_sample_count": 16}) == (16, 4)
