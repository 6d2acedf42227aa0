"""BENCHMARK.json against the contract's names and units, and every file
it names found by name."""

import importlib
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units():
    b = bench()
    metrics = b["end_to_end"] + b["per_layer"]
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in metrics]
             + [w["config"] for w in b["workloads"]]
             + [w["traffic"] for w in b["workloads"]]
             + [k for c in b["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in b[kind]]
        assert len(ns) == len(set(ns))
    ns = [m["name"] for m in metrics]
    assert len(ns) == len(set(ns))
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for text in ([w["why"] for w in b["workloads"]]
                 + [c["source"] for c in b["configs"]]
                 + [m["layer"] for m in b["per_layer"]] + b["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(b)) <= 64 * 1024


def test_files_found_by_name():
    b = bench()
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        for part in (("traffic", w["traffic"] + ".json"),
                     ("limits", w["name"] + ".json")):
            assert os.path.exists(os.path.join(ROOT, "benchmark", *part))
    for m in b["per_layer"]:
        mod = importlib.import_module(f"metrics.{m['name']}")
        assert mod.UNIT == m["unit"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


@pytest.mark.parametrize("name", ["sniffer_10mhz_raw", "sniffer_20mhz_raw"])
def test_config_keys(name):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           name + ".json")) as f:
        c = json.load(f)
    for k in ("sample_rate", "frames_per_block", "gone_capacity",
              "burst_batch", "agg_blocks", "group_jobs", "want_llr",
              "use_gardner", "detect_impl"):
        assert k in c
