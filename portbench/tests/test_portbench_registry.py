"""Everything a cell needs is found by name from its files, and
BENCHMARK.json keeps to the shape the harness reads."""

import json
import re

import pytest

from portbench import harness, readers
from portbench.program import Program

from ._cells import CELLS, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_cells_keep_the_rules():
    """The cells are BENCHMARK.json's, whatever they are: unique names
    ``<config>.<traffic>`` of a listed configuration, 1 or 4 chips with at
    most a quarter of the cells (rounded down, one always) on 4, a ``why``
    of 1-200 characters on one line, at most 24 cells."""
    cells = BENCH["workloads"]
    assert [w["name"] for w in cells] == list(CELLS)
    assert 1 <= len(cells) <= 24
    assert len(set(CELLS)) == len(CELLS)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in cells:
        assert NAME.match(w["name"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["config"] in configs
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    cell = harness.load_cell(ROOT, workload)
    assert harness.load_module("gen", cell.config["data"]["generator"])
    for key in ("direction", "warm_per_size", "judge_calls", "judge_setup",
                "trace_passes"):
        assert key in cell.traffic
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)


def test_every_metric_has_a_reader_and_every_name_keeps_the_rules():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(harness.load_module("metrics", m["name"]).read)
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
            assert m["name"][:-len("_roofline")] in harness.load_kernels()


CODERS = ("word_encode", "word_decode", "byte_encode", "byte_decode",
          "rans64_encode", "rans64_decode")


def test_kernels_name_a_symbol_direction_and_counter():
    """Every kernel file names its symbol, direction, variants and a
    counter that the program in this tree keeps (a missing one reads None
    only against an older program); a kernel of both directions brings
    its own byte rule, and the six coders keep their meaning."""
    kernels = harness.load_kernels()
    assert set(CODERS) <= set(kernels)
    for name, k in kernels.items():
        assert k["symbol"] and k["variants"]
        assert k["direction"] in ("encode", "decode", "both")
        assert isinstance(Program.launches(k["counter"]), int), name
        assert callable(readers.byte_rule(name, k))
    for name in CODERS:
        k = kernels[name]
        assert k["symbol"] == f"{name}_kernel"
        assert k["direction"] == name.split("_")[1]
        assert k["counter"].endswith(f":{k['direction']}_blocks")


def test_configs_list_their_cuts_and_keep_their_widths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert cfg[key] != cfg[f"published_{key}"]
    layer = json.loads(
        (ROOT / "portbench/configs/ckpt-dsv2lite-layer.json").read_text())
    assert (layer["hidden_size"], layer["moe_intermediate_size"],
            layer["kv_lora_rank"], layer["n_routed_experts"],
            layer["num_experts_per_tok"]) == (2048, 1408, 512, 64, 6)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell(ROOT, "text-zipf82-1e8.nothing")
