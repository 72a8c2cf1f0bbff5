"""BENCHMARK.json against the contract's limits on names, units and
lengths; every file it names is there and the harness finds it by name;
every per-layer metric moves an end-to-end metric its cells report."""
import json
import re

import pytest

from bench_port import manifest, traffic
from bench_port.inputs import params_of

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def entries():
    for group in ENTRY_KEYS:
        for e in MAN[group]:
            yield group, e


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(manifest.MANIFEST.read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)


def test_paths_and_command():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and ".." not in p.split("/")
        assert (manifest.ROOT / p).is_dir()
        assert not p.endswith("_torch")
    cmd = MAN["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])
            assert (manifest.ROOT / word).is_file()


@pytest.mark.parametrize("group,entry", list(entries()),
                         ids=lambda x: x if isinstance(x, str)
                         else x.get("name"))
def test_entry_keys_names_units_text(group, entry):
    # the harness reports every metric in every cell: no entry narrows
    # its cells with a "workloads" key
    assert set(entry) == ENTRY_KEYS[group]
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in TEXT_KEYS:
        if key in entry and group != "end_to_end" and \
                not (group == "per_layer" and key == "source"):
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text


def test_names_are_unique():
    names = [e["name"] for g in ("end_to_end", "per_layer") for e in MAN[g]]
    assert len(names) == len(set(names))
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MAN[group]]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_sources_and_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_file_is_there_and_found_by_name():
    for c in MAN["configs"]:
        path = manifest.config_path(MAN, c["name"])
        assert path.is_file()
        assert any(path.is_relative_to(manifest.ROOT / p)
                   for p in MAN["paths"])
        data = manifest.config(MAN, c["name"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        params_of(data).validate()
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4)
        traffic.load(manifest.traffic_path(w["traffic"]))
        manifest.config(MAN, w["config"])
    for m in MAN["per_layer"]:
        assert callable(manifest.load_metric(m["name"]).read)
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


def test_per_layer_moves_an_end_to_end_metric_its_cells_report():
    reported = {e["name"] for e in MAN["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert MAN["per_layer"]
    for m in MAN["per_layer"]:
        assert m["moves"] in reported and m["moves"] != "setup_s"


def test_layers_are_named_alike():
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["name"], m["layer"])
    assert all("\n" not in v for v in layers.values())


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_config_files_hold_their_keys():
    for c in MAN["configs"]:
        data = json.loads(manifest.config_path(MAN, c["name"]).read_text())
        for key in ("poly_modulus_degree", "coeff_modulus",
                    "plain_modulus", "max_batch", "assumed",
                    "reduced",
                    "source"):
            assert key in data
