"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a later PR's new traffic mix and metric by name."""

import json
import math
import re

import pytest

from _portbench_cpu import MANIFEST, ROOT, harness

from portbench import loadgen

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]+$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert cmd[1].startswith(MANIFEST["paths"][0] + "/")
    assert (ROOT / cmd[1]).is_file()
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH_CHARS.match(p) and len(p) <= 200 and not p.endswith(
            "_torch")
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    total = (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert (ROOT / "portbench" / "systems"
                / f"{data['system']}.py").is_file()


def test_workloads():
    configs = {c["name"] for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        loadgen.load(w["traffic"])
        limits = json.loads((ROOT / "portbench" / "checks"
                             / f"{w['name']}.json").read_text())
        assert limits and all("limit" in v for v in limits.values())
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_end_to_end_metrics():
    names = set()
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        names.add(m["name"])
    assert "setup_s" in names
    for w in MANIFEST["workloads"]:
        cell = harness.Cell(MANIFEST, w["name"])
        mine = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in mine and len(mine) >= 2
        assert cell.per_layer


def test_per_layer_metrics_move_a_metric_each_cell_reports():
    by_cell = {w["name"]: {m["name"] for m in
                           harness.Cell(MANIFEST, w["name"]).end_to_end}
               for w in MANIFEST["workloads"]}
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES and _line(m["layer"])
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        cells = m.get("workloads", [c for c, e in by_cell.items()
                                    if m["moves"] in e])
        assert cells
        for c in cells:
            assert m["moves"] in by_cell[c], (m["name"], c)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_file_under_paths_is_named_from_name_characters():
    for p in (ROOT / "portbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert PATH_CHARS.match(rel), rel


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    """A later PR adds a cell as files plus entries, editing none: a mix,
    a kind of traffic, a metric, its limits."""
    pb = tmp_path / "portbench"
    for sub in ("traffic", "checks", "metrics", "configs", "kinds"):
        (pb / sub).mkdir(parents=True)
    (pb / "kinds" / "closed_loop.py").write_text(
        (ROOT / "portbench/kinds/closed_loop.py").read_text())
    # a new kind of traffic is a new file, found by its name
    (pb / "kinds" / "open_loop.py").write_text(
        "def check(name, spec):\n"
        "    if spec['rate'] <= 0:\n"
        "        raise ValueError(name)\n\n\n"
        "def run(run, system):\n    pass\n")
    (pb / "traffic" / "stream_new.json").write_text(
        json.dumps({"kind": "open_loop", "rate": 50.0}))
    assert loadgen.load("stream_new", pb / "traffic",
                        pb / "kinds")["rate"] == 50.0
    assert hasattr(loadgen.kind("open_loop", pb / "kinds"), "run")
    mix = dict(json.loads((ROOT / "portbench/traffic/decode_b32.json")
                          .read_text()), clients=7)
    (pb / "traffic" / "chat_new.json").write_text(json.dumps(mix))
    (pb / "checks" / "stablelm.chat_new.json").write_text(
        json.dumps({"max_logit_gap": {"limit": 0.5}}))
    (pb / "configs" / "stablelm_2_1_6b_w4a8.json").write_text(
        (ROOT / "portbench/configs/stablelm_2_1_6b_w4a8.json").read_text())
    (pb / "metrics" / "tokens_per_client.py").write_text(
        "def read(run):\n    return run.seconds / 7\n")
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append({
        "name": "stablelm.chat_new", "config": "stablelm_2_1_6b_w4a8",
        "traffic": "chat_new", "chips": 1, "why": "a later cell"})
    manifest["per_layer"].append({
        "name": "tokens_per_client", "unit": "tokens/s", "better": "higher",
        "source": "host_clock", "layer": "serving/lm_engine.py",
        "moves": "tokens_per_s", "workloads": ["stablelm.chat_new"]})
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    e2e.setdefault("tokens_per_s", {
        "name": "tokens_per_s", "unit": "tokens/s", "better": "higher",
        "bound": 0.05, "source": "host_clock", "workloads": []})
    e2e["tokens_per_s"]["workloads"].append("stablelm.chat_new")
    manifest["end_to_end"] = list(e2e.values())
    if not any(c["name"] == "stablelm_2_1_6b_w4a8"
               for c in manifest["configs"]):
        manifest["configs"].append({
            "name": "stablelm_2_1_6b_w4a8",
            "file": "portbench/configs/stablelm_2_1_6b_w4a8.json"})
    cell = harness.Cell(manifest, "stablelm.chat_new", root=tmp_path)
    assert cell.traffic["clients"] == 7
    assert cell.limits == {"max_logit_gap": {"limit": 0.5}}
    assert "tokens_per_client" in {m["name"] for m in cell.per_layer}
    assert "tokens_per_s" in {m["name"] for m in cell.end_to_end}
    read = harness.metric_reader("tokens_per_client", root=pb)
    run = type("R", (), {"seconds": 14.0})()
    assert math.isclose(read(run), 2.0)
