"""The manifest against the benchmark's contract, and a cell's pieces
found by name: a new configuration, traffic mix and per-layer metric are
picked up from new files alone."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from vxbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_names_and_units(manifest):
    assert set(manifest) == KEYS
    assert manifest["command"][0] == "python3" and len(manifest["command"]) \
        <= 32
    assert all(_line(w) for w in manifest["command"])
    assert 1 <= manifest["run_seconds"] <= 51
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch")
    names = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) \
            and _line(c["source"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in
                                          manifest["paths"]))
        names.add(c["name"])
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(manifest["workloads"])
    cells = {w["name"] for w in manifest["workloads"]}
    seen = set()
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        assert m["name"] not in seen
        seen.add(m["name"])
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_cell_reports_what_the_contract_asks(manifest):
    for w in manifest["workloads"]:
        e2e, layer = harness.cell_metrics(manifest, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:
            assert m["moves"] in names


def test_each_cell_finds_its_pieces_by_name(manifest):
    for w in manifest["workloads"]:
        cell = harness.find_cell(manifest, w["name"])
        drv = harness.driver(cell.config["kind"])
        assert callable(drv.run)
        assert (harness.HERE / "reference"
                / f"{cell.config['reference']}.py").is_file()
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_additions_are_new_files_only(tmp_path, manifest):
    """A configuration, a traffic mix and a per-layer metric added to a
    copy as new files and manifest entries are found, and no file that
    was there changes."""
    shutil.copytree(harness.HERE, tmp_path / "vxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path / "vxbench")
    cfg = json.loads((harness.HERE / "configs"
                      / "render512_1080p.json").read_text())
    cfg["dims"] = [256, 256, 256]
    (tmp_path / "vxbench/configs/render256_1024.json").write_text(
        json.dumps(cfg))
    tr = json.loads((harness.HERE / "traffic" / "orbit.json").read_text())
    tr["radius"] = 0.2
    (tmp_path / "vxbench/traffic/closeup.json").write_text(json.dumps(tr))
    (tmp_path / "vxbench/metrics/frames_traced.frame.py").write_text(
        "def read(ctx):\n    return ctx.get('frames')\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "render256_1024", "source": "x",
                         "file": "vxbench/configs/render256_1024.json",
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "render256_1024.closeup",
                           "config": "render256_1024", "traffic": "closeup",
                           "chips": 1, "why": "a test"})
    for e in m["end_to_end"]:
        if "frame_mrays" == e["name"] or "frame_p95_ms" == e["name"]:
            e["workloads"].append("render256_1024.closeup")
    m["per_layer"].append({"name": "frames_traced.frame", "unit": "frames",
                           "better": "higher", "source": "program_counter",
                           "layer": "device", "moves": "frame_mrays",
                           "workloads": ["render256_1024.closeup"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = harness.find_cell(harness.load_manifest(tmp_path),
                             "render256_1024.closeup", root=tmp_path)
    assert cell.config["dims"] == [256, 256, 256]
    assert cell.traffic["radius"] == 0.2
    assert "frames_traced.frame" in {x["name"] for x in cell.per_layer}
    got = harness.read_layers(cell, {"kind": "frame", "frames": 7,
                                     "host_ms": [1.0], "frame_work": []},
                              root=tmp_path)
    assert got == {"frames_traced.frame": {"value": 7, "unit": "frames"}}
    after = _digests(tmp_path / "vxbench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "configs/render256_1024.json", "traffic/closeup.json",
        "metrics/frames_traced.frame.py"}
