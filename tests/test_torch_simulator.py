"""The port's copy of the paper's simulator (``repro_torch.simulator``,
numpy only) against the reference's ``repro.simulator``, to the bit.

* every function of ``hardware``, ``costmodel``, ``locality``,
  ``lru_sim``, ``pipeline`` and ``experiments`` on the same inputs and
  seeds: floats equal, arrays equal in value and dtype, dataclasses equal
  field by field (``calibrate`` and ``v5e_projection`` included);
* ``examples/simulate_paper_torch.py`` prints what
  ``examples/simulate_paper.py`` prints, line for line;
* the fidelity bands of the 13 tests of ``tests/test_paper_numbers.py``
  on the port's results, which this file counts as covered:
  ``test_headline_improvements_within_band``,
  ``test_table2_rows_within_tolerance``,
  ``test_fig1_batch_ceiling_and_monotonic_growth``,
  ``test_fig2_similarity_band``, ``test_fig4_warmup_kills_cold_spike``,
  ``test_fig5_layer_variability_range``, ``test_fig7_da_dba_crossover``,
  ``test_fig9_miss_decreases_with_context``,
  ``test_flashtrans_bandwidth_effect``,
  ``test_memory_ceilings_match_paper_operating_points``,
  ``test_lru_sim_warmup_monotone_in_ratio``,
  ``test_locality_trace_similarity_matches_churn`` and
  ``test_v5e_projection_ess_wins_more_on_smaller_hbm``.

The expensive experiments (the LRU replays of figures 5, 8 / 9, the
calibration grid) run once per package in a module fixture, at the
inputs ``test_paper_numbers.py`` gives them.  The numbers are the paper's
H800 model and the reference's TPU v5e projection, not measurements.
"""

import contextlib
import dataclasses
import io
import pathlib
import runpy

import numpy as np
import pytest

from repro.simulator import costmodel as JC
from repro.simulator import experiments as JE
from repro.simulator import hardware as JH
from repro.simulator import locality as JL
from repro.simulator import lru_sim as JS
from repro.simulator import pipeline as JP
from repro_torch.simulator import costmodel as TC
from repro_torch.simulator import experiments as TE
from repro_torch.simulator import hardware as TH
from repro_torch.simulator import locality as TL
from repro_torch.simulator import lru_sim as TS
from repro_torch.simulator import pipeline as TP

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the two packages, each as one namespace of its six modules
REF = dict(H=JH, C=JC, L=JL, S=JS, P=JP, E=JE)
PORT = dict(H=TH, C=TC, L=TL, S=TS, P=TP, E=TE)


def plain(x):
    """A comparable form: dataclasses as (type name, fields), arrays as
    (dtype, shape, bytes), containers element-wise."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, np.generic):
        return (type(x).__name__, x.item())
    return (type(x).__name__, x)


def same(a, b):
    assert plain(a) == plain(b)


# ---------------------------------------------------------------------------
# the expensive experiments, once per package
# ---------------------------------------------------------------------------

def _experiments(m):
    E, S, L, C, H = m["E"], m["S"], m["L"], m["C"], m["H"]
    return {
        "table2": E.table2(),
        "headline": E.headline_improvements(),
        "fig1": E.fig1_throughput_vs_batch(),
        "fig2": E.fig2_similarity(ctx_list=(32768,), layers=(0, 8, 24, 48)),
        "fig4": E.fig4_warmup(steps=24),
        "fig5": E.fig5_miss_by_layer(ratios=(0.2,)),
        "fig7": E.fig7_overlap_comparison(),
        "fig9": E.fig8_9_miss_vs_context(ratios=(0.2,),
                                         ctxs=(8192, 32768, 131072)),
        "flashtrans": E.flashtrans_comparison(),
        "memory": E.memory_analysis(),
        "v5e": E.v5e_projection(),
        "lru_small": S.miss_profile(32768, 0.1, layers=4, steps=16),
        "lru_big": S.miss_profile(32768, 0.6, layers=4, steps=16),
        "trace": L.make_trace(32, 8192, layer=3),
        "calibrate": C.calibrate(H.H800_EP32),
    }


@pytest.fixture(scope="module")
def ref_runs():
    return _experiments(REF)


@pytest.fixture(scope="module")
def port_runs():
    return _experiments(PORT)


@pytest.mark.parametrize("name", [
    "table2", "headline", "fig1", "fig2", "fig4", "fig5", "fig7", "fig9",
    "flashtrans", "memory", "v5e", "lru_small", "lru_big", "trace",
    "calibrate"])
def test_experiment_bitwise(ref_runs, port_runs, name):
    same(port_runs[name], ref_runs[name])


# ---------------------------------------------------------------------------
# every function on the same inputs
# ---------------------------------------------------------------------------

SC_VARIANTS = [
    dict(),
    dict(offload=True, sparse_memory_ratio=0.21, batch_per_gpu=160),
    dict(offload=True, sparse_memory_ratio=0.1, context=131072,
         batch_per_gpu=54, two_batch_overlap=False, overlap="layerwise"),
    dict(offload=True, paged_host=True, avg_miss_per_seq=200.0),
    dict(offload=True, async_offload=True, overlap="dba",
         sparse_memory_ratio=0.3, batch_per_gpu=128),
    dict(offload=True, use_flashtrans=False, warmup=False, mtp=4,
         accept_ratio=2.8, cache_bytes_per_row=578),
    dict(offload=True, overlap="none", batch_per_gpu=8),
]


def _sc(m, kw):
    return m["C"].ServeConfig(**kw)


CASES = {
    "hardware.profiles": lambda m: (m["H"].H800_EP32, m["H"].TPU_V5E,
                                    sorted(m["H"].PROFILES)),
    "hardware.mfu_curve": lambda m: [m["H"].MFUCurve()(r)
                                     for r in (1.0, 52.0, 830.0, 4096.0)]
    + [m["H"].H800_EP32.mfu(r) for r in (3.0, 480.0)],
    "costmodel.constants": lambda m: {
        k: v for k, v in vars(m["C"]).items()
        if k.isupper() and isinstance(v, (int, float))},
    "costmodel.serve_config": lambda m: [
        (_sc(m, kw), _sc(m, kw).q_len) for kw in SC_VARIANTS],
    "costmodel.active_params": lambda m: m["C"].active_params(),
    "costmodel.paged_transfer_model": lambda m: [
        (pm, pm.h2d_time(300.0, 40.0), pm.d2h_time(9.0, 1.0))
        for hw in (m["H"].H800_EP32, m["H"].TPU_V5E)
        for pm in (m["C"].paged_transfer_model(hw),
                   m["C"].paged_transfer_model(hw, 16, 578))],
    "costmodel.host_admission": lambda m: [
        (m["C"].host_bytes_per_seq(_sc(m, kw)),
         m["C"].host_bytes_per_seq(_sc(m, kw), avg_fill=0.9),
         m["C"].max_host_admission_batch(hw, _sc(m, kw)),
         m["C"].max_host_admission_batch(hw, _sc(m, kw), 0.6, 0.2))
        for kw in SC_VARIANTS + [dict(paged_host=True, host_page_rows=16)]
        for hw in (m["H"].H800_EP32, m["H"].TPU_V5E)],
    "costmodel.internode": lambda m: [
        (nm, nm.packet_bytes(r), nm.packet_bytes(r, 4), nm.transfer_time(r))
        for hw in (m["H"].H800_EP32, m["H"].TPU_V5E)
        for nm in (m["C"].internode_model(hw),
                   m["C"].internode_model(hw, 578))
        for r in (1.0, 2048.0, 0.43 * 32768)]
    + [m["C"].pd_migration_time_per_seq(m["H"].H800_EP32, _sc(m, kw))
       for kw in SC_VARIANTS + [dict(paged_host=True)]],
    "costmodel.layer_costs": lambda m: [
        m["C"].layer_costs(hw, _sc(m, kw), moe_layer=moe, miss_per_seq=miss)
        for hw in (m["H"].H800_EP32, m["H"].TPU_V5E)
        for kw in SC_VARIANTS for moe in (False, True)
        for miss in (0.0, 128.0, 1500.0)],
    "costmodel.gemm_lm_head_weights": lambda m: [
        (m["C"]._gemm_time(m["H"].H800_EP32, rows, 1e12, 4e9),
         m["C"].lm_head_time(m["H"].TPU_V5E, _sc(m, kw)),
         m["C"].weights_bytes_per_gpu(_sc(m, kw)))
        for rows, kw in zip((1.0, 156.0, 900.0, 5000.0, 2.0, 3.0, 4.0),
                            SC_VARIANTS)],
    "costmodel.cache_and_batch": lambda m: [
        (m["C"].cache_bytes_per_seq(ctx, r, off),
         m["C"].max_feasible_batch(hw, _sc(m, dict(
             context=ctx, sparse_memory_ratio=r, offload=off))),
         m["C"].max_feasible_batch(hw, _sc(m, dict(context=ctx)), 2e9, 0.8))
        for ctx in (8192, 32768, 131072)
        for r, off in ((1.0, False), (0.2, True))
        for hw in (m["H"].H800_EP32, m["H"].TPU_V5E)],
    "locality.layer_churn": lambda m: [
        m["L"].layer_churn(layer) for layer in range(0, 130, 7)]
    + [m["L"].layer_churn(5, n_layers=16, lo=0.01, hi=0.2, seed=9)],
    "locality.expected_miss": lambda m: [
        m["L"].expected_miss_per_seq(ctx, r, layer=layer, warmed=w, topk=k)
        for ctx in (1024, 32768, 131072) for r in (0.05, 0.2, 1.0)
        for layer in (0, 17) for w in (True, False) for k in (2048, 512)],
    "locality.make_trace": lambda m: [
        m["L"].make_trace(12, 4096, layer=2, topk=256, seed=4),
        m["L"].make_trace(8, 1500, layer=40, seed=1, zipf_a=0.9,
                          recency_frac=0.5)],
    "locality.similarity": lambda m: m["L"].similarity_of_trace(
        m["L"].make_trace(16, 4096, layer=9, topk=128, seed=2)),
    "lru_sim.numpy_lru": lambda m: _lru_replay(m),
    "lru_sim.run_lru": lambda m: [
        m["S"].run_lru(m["L"].make_trace(20, 8192, layer=5, topk=256),
                       r, 8192, warmup_windows=w)
        for r in (0.05, 0.3) for w in (0, 4)],
    "lru_sim.miss_profile": lambda m: m["S"].miss_profile(
        8192, 0.2, layers=3, steps=12, warmup=False, seed=2),
    "lru_sim.early_miss_curve": lambda m: [
        m["S"].early_miss_curve(8192, 0.2, steps=8, warmup=w, mtp=q)
        for w in (True, False) for q in (1, 3)],
    "pipeline.layer_time": lambda m: [
        (m["P"].layer_time(c, o), m["P"].pick_overlap(m["H"].H800_EP32, c,
                                                      _sc(m, {})))
        for c in (m["C"].layer_costs(m["H"].H800_EP32, _sc(m, kw),
                                     moe_layer=True, miss_per_seq=miss)
                  for kw in SC_VARIANTS for miss in (0.0, 256.0, 2048.0))
        for o in ("none", "da", "dba")],
    "pipeline.simulate_step": lambda m: [
        (m["P"].simulate_step(hw, _sc(m, kw)),
         m["P"].throughput_node(hw, _sc(m, kw)),
         m["P"].otps(hw, _sc(m, kw)))
        for hw in (m["H"].H800_EP32, m["H"].TPU_V5E) for kw in SC_VARIANTS],
    "pipeline.miss_by_layer": lambda m: [
        m["P"].simulate_step(m["H"].H800_EP32, _sc(m, dict(offload=True)),
                             miss_by_layer=[float(7 * i % 300)
                                            for i in range(61)]),
        m["P"].throughput_node(m["H"].TPU_V5E, _sc(m, dict(offload=True)),
                               [64.0] * 61)],
    "experiments.table_data": lambda m: (
        m["E"].PAPER_TABLE2,
        [m["E"]._sc(*row[:7]) for row in m["E"].PAPER_TABLE2]),
    "experiments.small_args": lambda m: (
        m["E"].fig1_throughput_vs_batch(m["H"].TPU_V5E, ctx=8192),
        m["E"].fig2_similarity(ctx_list=(4096,), layers=(1,), steps=8),
        m["E"].fig4_warmup(ctx=8192, ratio=0.3, steps=6),
        m["E"].fig5_miss_by_layer(ctx=4096, ratios=(0.5,)),
        m["E"].fig8_9_miss_vs_context(ratios=(0.4,), ctxs=(4096,)),
        m["E"].flashtrans_comparison(m["H"].TPU_V5E, miss=64.0),
        m["E"].table2(m["H"].TPU_V5E),
        m["E"].headline_improvements(m["H"].TPU_V5E),
        m["E"].fig7_overlap_comparison(m["H"].TPU_V5E),
        m["E"].memory_analysis(m["H"].TPU_V5E)),
}


def _lru_replay(m):
    lru = m["S"].NumpyLRU(300, 4096)
    tr = m["L"].make_trace(10, 4096, layer=1, topk=256, seed=3)
    return ([lru.access(row) for row in tr], lru.ids, lru.last,
            lru.slot_of, lru.step)


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_bitwise(case):
    same(CASES[case](PORT), CASES[case](REF))


def test_layer_time_rejects_unknown_overlap():
    c = TC.layer_costs(TH.H800_EP32, TC.ServeConfig(), moe_layer=True,
                       miss_per_seq=0.0)
    with pytest.raises(ValueError):
        TP.layer_time(c, "tbo")
    with pytest.raises(ValueError):
        JP.layer_time(JC.layer_costs(JH.H800_EP32, JC.ServeConfig(),
                                     moe_layer=True, miss_per_seq=0.0), "tbo")


def test_port_cluster_link_is_the_costmodel_one():
    """The cluster's channel model and the example mirror's
    ``internode_model(H800_EP32)`` come from this one module."""
    from repro_torch.cluster import kv_transfer as KT
    nm = TC.internode_model(TH.H800_EP32)
    ch = KT.InterNodeChannel(model=nm, step_time_s=5e-3)
    assert isinstance(nm, TC.InterNodeModel)
    assert ch.model.bandwidth == TH.H800_EP32.fabric_bw
    assert ch.model.latency_s == TH.H800_EP32.a2a_latency


def test_simulate_paper_mirror_prints_the_same_lines():
    def run(name):
        mod = runpy.run_path(str(ROOT / "examples" / name),
                             run_name="mirror")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod["main"]()
        return buf.getvalue().splitlines()
    ref, port = run("simulate_paper.py"), run("simulate_paper_torch.py")
    assert len(port) > 30
    assert port == ref


# ---------------------------------------------------------------------------
# test_paper_numbers.py's fidelity bands on the port's results
# ---------------------------------------------------------------------------

def test_paper_headline_improvements_within_band(port_runs):
    h = port_runs["headline"]
    assert abs(h["improvement_32k_pct"] - 69.4) < 15.0, h
    assert h["improvement_128k_pct"] > 80.0, h
    assert h["improvement_128k_pct"] > h["improvement_32k_pct"]


def test_paper_table2_rows_within_tolerance(port_runs):
    rows = port_runs["table2"]
    assert len(rows) == 18
    devs = [abs(r["dev_pct"]) for r in rows]
    assert np.median(devs) < 10.0, devs
    assert max(devs) < 25.0, devs


def test_paper_fig1_batch_ceiling_and_monotonic_growth(port_runs):
    rows = port_runs["fig1"]
    cap_feasible = [r["batch"] for r in rows if r["feasible_on_gpu"]]
    assert 40 <= max(cap_feasible) <= 64, cap_feasible
    thr = [r["throughput"] for r in rows]
    assert thr[-1] > 1.5 * thr[0]


def test_paper_fig2_similarity_band(port_runs):
    sims = [r["similarity_mean"] for r in port_runs["fig2"]]
    assert all(0.55 <= s <= 1.0 for s in sims), sims
    assert np.mean(sims) > 0.85


def test_paper_fig4_warmup_kills_cold_spike(port_runs):
    w = port_runs["fig4"]
    assert w["before_warmup"][0] > 10 * max(w["after_warmup"][0], 1)
    assert abs(np.mean(w["before_warmup"][8:])
               - np.mean(w["after_warmup"][8:])) < 50


def test_paper_fig5_layer_variability_range(port_runs):
    r = port_runs["fig5"][0]
    assert r["miss_min"] < 60
    assert r["miss_max"] > 150
    assert r["miss_max"] / max(r["miss_min"], 1e-9) > 5


def test_paper_fig7_da_dba_crossover(port_runs):
    by_miss = {r["miss"]: r for r in port_runs["fig7"]}
    assert by_miss[32]["da_ms"] <= by_miss[32]["dba_ms"]
    assert by_miss[512]["dba_ms"] < by_miss[512]["da_ms"]
    assert by_miss[512]["dba_ms"] < by_miss[512]["none_ms"]


def test_paper_fig9_miss_decreases_with_context(port_runs):
    miss = {r["context"]: r["miss_mean"] for r in port_runs["fig9"]}
    assert miss[131072] <= miss[32768] <= miss[8192] * 1.5


def test_paper_flashtrans_bandwidth_effect(port_runs):
    f = port_runs["flashtrans"]
    assert 30 <= f["speedup"] <= 60, f


def test_paper_memory_ceilings_match_operating_points(port_runs):
    m = port_runs["memory"]
    assert 40 <= m["ctx32768_ratio1.0"] <= 64
    assert m["ctx32768_ratio0.2"] >= 128
    assert m["ctx131072_ratio0.1"] >= 50
    assert m["ctx131072_ratio1.0"] <= 16


def test_paper_lru_sim_warmup_monotone_in_ratio(port_runs):
    assert port_runs["lru_big"].mean() < port_runs["lru_small"].mean()


def test_paper_locality_trace_similarity_matches_churn(port_runs):
    sim = TL.similarity_of_trace(port_runs["trace"])
    assert abs((1 - sim.mean()) - TL.layer_churn(3)) < 0.12


def test_paper_v5e_projection_ess_wins_more_on_smaller_hbm(port_runs):
    by_ctx = {r["context"]: r for r in port_runs["v5e"]}
    assert by_ctx[32768]["improvement_pct"] > 60
    assert by_ctx[131072]["improvement_pct"] > 100
    for r in port_runs["v5e"]:
        assert r["batch_ess"] > 2 * r["batch_base"]
