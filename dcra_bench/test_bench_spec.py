"""BENCHMARK.json against the format its readers hold it to: keys, names,
units, lengths, the metrics each cell reports, the time a full check
takes."""
import json
import re

import pytest

from dcra_bench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden_size|intermediate|latent|"
                    r"state_size|projection|head_size|expan|per_tok")


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == KEYS["top"]
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    assert len(SPEC["command"]) <= 32
    assert all(line_ok(w) for w in SPEC["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(set(names)) == len(names)
    for e in SPEC[section]:
        extra = set(e) - KEYS[section] - (
            {"workloads"} if section in ("end_to_end", "per_layer") else
            set())
        assert set(e) >= KEYS[section] and not extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads") or (
                    key == "layer" and key in e):
                assert line_ok(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_configs_and_cells():
    cfgs = {c["name"] for c in SPEC["configs"]}
    used = {w["config"] for w in SPEC["workloads"]}
    assert cfgs == used
    for c in SPEC["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert all(NAME.match(w["traffic"]) for w in SPEC["workloads"])


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for w in SPEC["workloads"]:
        mine = [m for m in e2e.values() if harness.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in SPEC["per_layer"]
                 if harness.applies(m, w["name"])]
        assert layer, w["name"]
        for m in layer:
            assert harness.applies(e2e[m["moves"]], w["name"]), m["name"]


def test_layer_names_and_shares():
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in (
                m["name"]):
            assert m["unit"] == "%"


def test_a_full_check_fits_with_every_cell():
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
