"""BENCHMARK.json against its rules, and the files each cell resolves
to by name."""
import json
import re
import shutil

import pytest

from port_bench.lib import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.resolve(name, BENCH)
    assert cell.traffic["driver"] in ("serve", "train")
    spec.driver(cell)
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
    assert cell.limits, "every cell holds its outputs to limits"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    model = cell.config["model"]
    assert model["compute_dtype"] == "float32"


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]])
    for n in names:
        assert spec.NAME.match(n), n
    for m in METRICS:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for entry in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_entries_have_exactly_their_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {
            "name", "unit", "better", "bound", "source"}, m
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {
            "name", "unit", "better", "source", "layer", "moves"}, m


def test_moves_and_workloads_agree():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    reports = {c: {m for m in e2e
                   if c in e2e[m].get("workloads", [c])} for c in CELLS}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m
        for c in m.get("workloads", CELLS):
            assert c in CELLS and m["moves"] in reports[c], (m, c)
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for m in METRICS:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_paths_and_command():
    assert BENCH["command"][:2] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] == []
        assert body["name"] == c["name"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_cell_is_added_with_files_alone(tmp_path):
    """A new traffic mix, limits file and BENCHMARK.json entry make a cell
    the harness resolves, with its metrics chosen from the entries."""
    bench_dir = tmp_path / "port_bench"
    shutil.copytree(spec.BENCH_DIR / "configs", bench_dir / "configs")
    (bench_dir / "traffic").mkdir()
    (bench_dir / "limits").mkdir()
    (bench_dir / "traffic" / "serve_b4.json").write_text(json.dumps(
        {"driver": "serve", "batch": 4, "pool": 2, "check_calls": 1,
         "trace_calls": 2, "enqueue_calls": 2, "block_calls": 2}))
    (bench_dir / "limits" / "live.serve_b4.json").write_text(json.dumps(
        {"decode_flips": 0, "map_gap": 1e-3}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "live.serve_b4", "config": "live",
                               "traffic": "serve_b4", "chips": 1,
                               "why": "a dummy cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "live.serve_b16" in m.get("workloads", []):
            m["workloads"].append("live.serve_b4")
    cell = spec.resolve("live.serve_b4", bench, bench_dir)
    assert cell.traffic["batch"] == 4
    assert {m["name"] for m in cell.end_to_end} == {
        "serve_img_per_s", "peak_mem_gb", "setup_s"}
    assert "mfu.serve" in {m["name"] for m in cell.per_layer}
    assert spec.driver(cell).__name__.endswith("drivers.serve")


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.resolve("live.nothing", BENCH)


def test_names_of_files_under_paths():
    for path in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
