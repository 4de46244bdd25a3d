"""Every piece ``BENCHMARK.json`` names loads by name, and the file keeps
the benchmark's contract: keys, names, units, bounds, the metrics each
cell reports, and configurations at published widths."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(REPO)]

from essbench import spec as S  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["essbench"]
    assert BENCH["command"] == ["python3", "essbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells at this length fits the driver's budget
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200


def test_every_cell_reports_what_its_metrics_move():
    specs = S.Specs()
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in specs.metrics(w["name"], False)}
        per = specs.metrics(w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in
                                  specs.metrics(cell, False)}, (m, cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    specs = S.Specs()
    wl = specs.json("workloads", cell)
    entry = specs.cell(cell)
    assert wl["config"] == entry["config"] and wl["traffic"] == \
        entry["traffic"] and wl["chips"] == entry["chips"]
    assert wl["why"] == entry["why"]
    assert callable(specs.module("traffic", wl["traffic"]).run)
    assert wl["check"]["logit_gap_max"] > 0
    for m in specs.metrics(cell, False) + specs.metrics(cell, True):
        mod = specs.module("metrics", m["name"])
        assert mod.SOURCE == m["source"] and callable(mod.read)
    conf = specs.json("configs", wl["config"])
    assert callable(specs.module("reference", conf["reference"]).served_gaps)


def test_a_dotted_metric_falls_back_to_its_stem(tmp_path):
    """``mfu.pd`` is read by ``metrics/mfu.py`` unless a file of its own
    name exists, in any root."""
    specs = S.Specs(BENCH, roots=[tmp_path])
    assert specs.module("metrics", "mfu.pd").__file__.endswith("/mfu.py")
    assert specs.module("metrics", "itl_p95_ms.any.cell").__file__.endswith(
        "/itl_p95_ms.py")
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "mfu.pd.py").write_text(
        'SOURCE = "device_trace"\n')
    assert specs.module("metrics", "mfu.pd").__file__ == str(
        tmp_path / "metrics" / "mfu.pd.py")
    with pytest.raises(FileNotFoundError):
        specs.module("metrics", "no_such_metric.pd")


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=lambda e: e["name"])
def test_configs_build_the_ports_config_at_published_widths(entry):
    conf = json.loads((REPO / entry["file"]).read_text())
    assert conf["source"] == entry["source"]
    assert set(entry["reduced"]) == set(conf["published"])
    for k in entry["reduced"]:
        assert conf[k] != conf["published"][k]
    cfg = S.arch_config(conf)        # every published key checked inside
    assert (cfg.d_model, cfg.num_heads, cfg.vocab_size) == (7168, 128,
                                                           129280)
    assert (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) == 576
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert) == (
        256, 8, 2048)
    assert cfg.num_layers == 4 and cfg.mtp_depth == 0
    # dropless: the capacity covers every token
    assert cfg.moe.top_k * cfg.moe.capacity_factor >= cfg.moe.num_experts
    if cfg.dsa is not None:
        assert cfg.dsa.index_topk == 2048 and cfg.ess.max_miss_ratio == 1.0


def test_a_config_that_departs_from_the_port_is_refused():
    conf = json.loads((REPO / "essbench/configs/dsv3-4l.json").read_text())
    with pytest.raises(ValueError, match="hidden_size"):
        S.arch_config({**conf, "hidden_size": 4096})
