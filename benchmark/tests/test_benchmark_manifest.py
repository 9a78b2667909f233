"""``BENCHMARK.json`` keeps to its contract, and every file it names is
found by name."""

import json
import math
import re

import pytest

from benchmark.common import manifest as M

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return M.load_manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits(manifest):
    assert set(manifest) == KEYS
    assert len(json.dumps(manifest)) < 64 * 1024
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits into 43,200 s
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in manifest[group]]
        assert len(names) == len(set(names)), group
        for e in manifest[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer"):
                if key in e:
                    assert _line(e[key]), e[key]
    metrics = [m["name"] for m in manifest["end_to_end"]
               + manifest["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for c in manifest["configs"]:
        assert _line(c["source"])
    assert all(_line(word) for word in manifest["command"])


def test_entries_have_the_contract_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert PATH.match(c["file"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_e2e_and_a_layer(manifest):
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    for w in manifest["workloads"]:
        e2e = {m["name"] for m in M.metrics_of_cell(manifest, w["name"],
                                                    False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = M.metrics_of_cell(manifest, w["name"], True)
        assert layers
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_layers_of_one_name_agree_and_shares_are_named(manifest):
    for m in manifest["per_layer"]:
        if m["name"].endswith("_roofline_pct.serve") or "roofline" in \
                m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] and m["moves"] == "train_slices_per_s"
               for m in manifest["per_layer"])
    assert any("mfu" in m["name"] and m["moves"] == "volumes_per_s"
               for m in manifest["per_layer"])


def test_every_file_is_found_by_name(manifest):
    from benchmark.common import context as C

    for w in manifest["workloads"]:
        cfg = M.config_file(manifest, w)
        assert cfg["name"] == w["config"]
        assert cfg["reduced"] == M.config_entry(manifest, w)["reduced"]
        mix = M.mix_file(w)
        kind = M.kind_module(mix["kind"])
        assert callable(kind.run) and callable(kind.control)
        limits = C.limits_of(w["name"])
        assert limits and all(math.isfinite(v) for v in limits.values())
        __import__(f"benchmark.reference.{cfg['reference']}")
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(M.reader(m["name"]))


def test_config_files_state_the_published_widths(manifest):
    for c in manifest["configs"]:
        cfg = M.read_json(M.ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert (cfg["outputWidth"], cfg["zDim"], cfg["intermediateResolutions"]
                ) == (128, 128, [8, 8])
        assert cfg["compute_dtype"] == "bfloat16"
        assert cfg["reduced"] == []
