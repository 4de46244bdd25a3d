"""The harness end to end on the CPU, on throwaway cells at smoke widths.

Each cell lives in a folder of the test's own (``smoke_cells``): a
configuration, a workload and, for one test, a metric, found by name as
the benchmark's own are.  A sound run is correct; the float8 control and
each planted fault (``faults``) make the check come out false.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[0:0] = [str(HERE.parents[1]), str(HERE)]

import faults as F  # noqa: E402
import smoke_cells as SC  # noqa: E402

from essbench import harness as H  # noqa: E402
from essbench import spec as S  # noqa: E402

KINDS = {"t-pd": "pd_closed_loop", "t-v3": "fixed_batch_replay",
         "t-chat": "open_loop_chat"}
SECONDS = 0.6


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return SC.write(tmp_path_factory.mktemp("cells"))


def run(root, cell, seed=7, trace=False, quant=None, bench=None):
    specs = S.Specs(bench or SC.bench(), roots=[root])
    return H.run_cell(specs, cell, seed, SECONDS, trace,
                      device=torch.device("cpu"), t_start=time.perf_counter(),
                      quant=quant)


@pytest.mark.parametrize("cell", sorted(KINDS))
def test_sound_run_is_correct_and_the_control_is_not(root, cell):
    res = run(root, cell, seed=2**31 + 11, quant="fp8")
    assert res["correct"], res["readings"]
    assert res["readings"]["tokens_compared"] > 0
    # the control: the reference in float8, in the program's place, judged
    # by the same comparison
    assert res["readings"]["control_correct"] is False
    assert res["readings"]["control_gap"] > SC.LIMIT
    names = {m["name"] for m in S.Specs(SC.bench()).metrics(cell, False)}
    assert set(res["metrics"]) == names
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", F.FAULTS)
@pytest.mark.parametrize("cell", sorted(KINDS))
def test_planted_fault_fails_the_check(root, cell, fault, monkeypatch):
    F.plant(monkeypatch, fault, KINDS[cell])
    res = run(root, cell)
    assert not res["correct"], res["readings"]
    assert res["numbers"]["logit_gap_max"]["value"] > SC.LIMIT


def test_traced_run_reads_the_counters_and_no_device_metric(root):
    res = run(root, "t-pd", trace=True)
    m = res["metrics"]
    assert {"slots_live_mean.pd", "pool_hit_rate.pd",
            "tier_MB_per_token.pd"} <= set(m)
    # no device activity on the CPU: every device-trace metric stays out
    dev = {e["name"] for e in SC.bench()["per_layer"]
           if e["source"] == "device_trace"}
    assert not dev & set(m)
    assert m["slots_live_mean.pd"]["value"] == pytest.approx(4.0)
    tr = res["run"].trace
    assert tr["busy_s"] == 0.0 and tr["window_s"] > 0
    assert [g[0] for g in tr["breakdown"]["idle_gaps"]][0] in (
        "step_round", "bookkeeping", "install")


def test_a_new_metric_and_cell_are_files_and_entries(root, tmp_path):
    """A later PR adds a cell, its end-to-end metrics and a per-layer
    metric as new files plus new ``BENCHMARK.json`` entries; no file of the
    harness changes.  The cell's copy of an end-to-end metric needs no file:
    ``decode_tok_s.short`` is read by ``metrics/decode_tok_s.py``."""
    extra = tmp_path / "extra"
    (extra / "metrics").mkdir(parents=True)
    (extra / "workloads").mkdir()
    (extra / "metrics" / "rounds_in_window.x.py").write_text(
        'SOURCE = "program_counter"\n\n\ndef read(run, ctx):\n'
        '    return run.counters["rounds"]\n')
    wl = json.loads((root / "workloads" / "t-v3.json").read_text())
    wl.update(name="t-v3-short", params={**wl["params"], "new_tokens": 3})
    (extra / "workloads" / "t-v3-short.json").write_text(json.dumps(wl))
    bench = SC.bench()
    bench["workloads"].append({"name": "t-v3-short", "config": "smoke-v3",
                               "traffic": "fixed_batch_replay", "chips": 1,
                               "why": "cpu"})
    for name, unit in (("decode_tok_s.short", "tokens/s"),
                       ("itl_p95_ms.short", "ms")):
        bench["end_to_end"].append({
            "name": name, "unit": unit, "better": "lower", "bound": 0.05,
            "source": "host_clock", "workloads": ["t-v3-short"]})
    bench["per_layer"].append({
        "name": "rounds_in_window.x", "unit": "rounds", "better": "higher",
        "source": "program_counter", "layer": "serving (scheduler)",
        "moves": "decode_tok_s.short", "workloads": ["t-v3-short"]})
    specs = S.Specs(bench, roots=[extra, root])
    res = H.run_cell(specs, "t-v3-short", 3, SECONDS, True,
                     device=torch.device("cpu"), t_start=time.perf_counter())
    assert res["correct"]
    assert set(res["metrics"]) >= {"rounds_in_window.x"}
    assert res["metrics"]["rounds_in_window.x"]["value"] > 0
    res = H.run_cell(specs, "t-v3-short", 3, SECONDS, False,
                     device=torch.device("cpu"), t_start=time.perf_counter())
    assert set(res["metrics"]) == {"decode_tok_s.short", "itl_p95_ms.short",
                                   "setup_s"}


# a plain reference of the test's own: the benchmark's, or one that reads
# every gap a whole logit too wide, which no sound run can keep
OWN_REFERENCES = {
    "own_copy": None,
    "own_shifted": ("from essbench.reference.deepseek import served_gaps "
                    "as _ref\n\n\ndef served_gaps(*a, **k):\n"
                    "    out = _ref(*a, **k)\n"
                    "    out['gap'] = out['gap'] + 1.0\n"
                    "    return out\n"),
}


@pytest.mark.parametrize("reference", sorted(OWN_REFERENCES))
def test_a_new_configuration_brings_its_own_reference(root, tmp_path,
                                                      reference):
    """A configuration of another family names its plain reference, a file
    of its own under ``reference/``; the harness checks the served tokens
    against that file, with no edit of its own."""
    extra = tmp_path / "extra"
    for kind in ("configs", "workloads", "reference"):
        (extra / kind).mkdir(parents=True)
    src = OWN_REFERENCES[reference]
    if src is None:
        src = (HERE.parent / "reference" / "deepseek.py").read_text()
    (extra / "reference" / f"{reference}.py").write_text(src)
    conf = json.loads((root / "configs" / "smoke-v3.json").read_text())
    conf.update(name="smoke-own", reference=reference)
    (extra / "configs" / "smoke-own.json").write_text(json.dumps(conf))
    wl = json.loads((root / "workloads" / "t-v3.json").read_text())
    wl.update(name="t-own", config="smoke-own")
    (extra / "workloads" / "t-own.json").write_text(json.dumps(wl))
    bench = SC.bench()
    bench["workloads"].append({"name": "t-own", "config": "smoke-own",
                               "traffic": "fixed_batch_replay", "chips": 1,
                               "why": "cpu"})
    specs = S.Specs(bench, roots=[extra, root])
    res = H.run_cell(specs, "t-own", 5, SECONDS, False,
                     device=torch.device("cpu"), t_start=time.perf_counter())
    gap = res["numbers"]["logit_gap_max"]["value"]
    if reference == "own_copy":
        assert res["correct"] and gap <= SC.LIMIT
    else:
        assert not res["correct"] and gap >= 1.0
