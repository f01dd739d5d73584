"""BENCHMARK.json against the benchmark's contract, and the harness finding
cells, configurations, traffic mixes and metrics by name."""

import json
import os
import re
import shutil

import pytest

from benchmark import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    for section in ("end_to_end", "per_layer"):
        for m in manifest[section]:
            assert UNIT.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert all(NAME.match(n) for n in names), names
    for text in [c["source"] for c in manifest["configs"]] + [
            w["why"] for w in manifest["workloads"]] + [
            m["layer"] for m in manifest["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(set(names)) == len(names)


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])


def _reports(manifest, section, metric, cell):
    m = [x for x in manifest[section] if x["name"] == metric][0]
    return cell in m.get("workloads", [cell])


def test_per_layer_cells_report_what_they_move(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(manifest, "end_to_end", m["moves"], cell), \
                (m["name"], cell)


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        cell = w["name"]
        e2e = [m["name"] for m in manifest["end_to_end"]
               if _reports(manifest, "end_to_end", m["name"], cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(manifest, "per_layer", m["name"], cell)
                   for m in manifest["per_layer"])


def test_every_name_has_its_files(manifest):
    for w in manifest["workloads"]:
        cell = run.Cell(w["name"])
        assert cell.limits and set(cell.params) >= {"sets", "resume",
                                                    "profile_stitches"}
        for section in ("end_to_end", "per_layer"):
            for m in cell.metrics(section):
                assert callable(cell.reader(m["name"]))


def test_cell_found_from_files_alone(tmp_path):
    """A new cell and a new metric are taken from added files and entries,
    with no edit of the harness."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    manifest["workloads"].append(
        {"name": "ring8.stitch3", "config": "ring8", "traffic": "stitch",
         "chips": 1, "why": "three capture sets"})
    manifest["per_layer"].append(
        {"name": "stitches_s", "unit": "s", "better": "lower",
         "source": "program_span", "layer": "ingest",
         "moves": "stitch_mp_per_s", "workloads": ["ring8.stitch3"]})
    manifest["per_layer"].append(
        {"name": "crop_s", "unit": "s", "better": "lower",
         "source": "program_span", "layer": "compose",
         "moves": "stitch_mp_per_s", "workloads": ["ring8.stitch3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    (root / "benchmark" / "workloads" / "ring8.stitch3.json").write_text(
        json.dumps({"config": "ring8", "traffic": "stitch",
                    "params": {"sets": 3}, "limits": {"reproj_px": 1.0}}))
    (root / "benchmark" / "metrics" / "stitches_s.py").write_text(
        "def read(ctx):\n    return sum(ctx.walls)\n")
    # A stage metric is data alone: the stage's name.
    (root / "benchmark" / "metrics" / "crop_s.json").write_text(
        json.dumps({"stage": "Cropping"}))
    cell = run.Cell("ring8.stitch3", root=str(root))
    assert cell.params["sets"] == 3 and cell.params["resume"] is False
    assert [m["name"] for m in cell.metrics("per_layer")] == ["stitches_s",
                                                               "crop_s"]
    assert cell.reader("stitches_s")(run.Context(walls=[1.0, 2.5])) == 3.5
    ctx = run.Context(stage_means={"Cropping": 0.25})
    assert cell.reader("crop_s")(ctx) == 0.25
    assert cell.reader("crop_s")(run.Context(stage_means={})) is None
    # A metric split by the end-to-end metric it moves reads as its base.
    assert cell.reader("crop_s.resume")(ctx) == 0.25
    assert cell.reader("stitches_s.resume")(run.Context(walls=[2.0])) == 2.0
