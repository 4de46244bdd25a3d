"""esslint for the port (``repro_torch.analysis``): the lint rules on
fixtures, the findings and baseline mechanics, the CLI, the port's tree,
every runtime audit's pure checker with its sabotage case, and the audit
drivers on CPU smoke sessions and a CPU smoke cluster.

Reference tests of ``tests/test_analysis.py`` counted as covered here:
the ESS001 / ESS002 fixtures (``test_ess001_*``, ``test_ess002_*``; the
reference's ``jax.device_get`` is the port's ``.synchronize()`` outside
the fetch sites), ``test_inline_disable_suppresses``,
``test_disable_on_multiline_call_span``,
``test_fingerprint_ignores_line_numbers``,
``test_baseline_roundtrip_and_split``, ``test_findings_json_shape``,
``test_cli_exit_codes``, ``test_repo_tree_is_clean_minus_suppressions``,
``test_dtype_checker_flags_drift``, ``test_fetch_checker_budget_and_total``,
``test_retrace_checker`` (the capture checker),
``test_fetch_golden_real_session``, ``test_fetch_audit_catches_leaky_session``,
``test_migration_pack_checker``, ``test_migration_pack_golden_cluster`` and
``test_migration_pack_audit_catches_smuggled_fetch``;
``test_retrace_golden_real_workload`` is the card's capture audit in
``tests/test_torch_cuda.py`` (a CUDA graph is captured only there).

Not ported, and why:

* ESS003 (Python branching on traced values) and ESS004 (``jax.jit``
  without donation): eager torch traces nothing and donates nothing, so
  ``test_ess003_*`` and ``test_ess004_*`` have no counterpart;
* ESS101 (donation) and the jaxpr dtype goldens
  (``test_targets_cover_all_round_kinds``, ``test_donation_*``,
  ``test_dtype_golden_*``, ``test_find_big_upcasts_positive_and_threshold``):
  there is no lowered program; the port's rounds update one persistent
  state in place, which ESS104 checks on the live state instead;
* ESS105 (the slab refill off the token path): its two rules are read
  from a backward slice of the round's jaxpr.  In eager torch rule (b)
  is a question of streams and events that only the card answers
  (``chip_smoke.py``'s profiled slab-gather overlap, session F), and rule
  (a) reduces to "prefetch hits > 0", which ``test_torch_pipeline.py``
  already asserts.  No cheap runtime form adds to those.
"""

import _torch_cpu  # noqa: F401  (one torch thread: see the module)
import dataclasses
import json
import pathlib
import textwrap

import pytest
import torch

from repro_torch.analysis import audit as A
from repro_torch.analysis import contracts as C
from repro_torch.analysis import lint as L
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.findings import (Finding, findings_to_json,
                                           load_baseline,
                                           split_against_baseline,
                                           write_baseline)
from repro_torch.cluster import kv_transfer as TKT
from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.serving import engine as TE
from repro_torch.serving.scheduler import Request

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def short():
    """A short workload for the sabotage cases: one greedy, one sampled."""
    return [Request(rid=0, prompt_len=8, max_new_tokens=3),
            Request(rid=1, prompt_len=9, max_new_tokens=2, temperature=0.9,
                    seed=5)]


def _lint(src, relpath="repro_torch/serving/fixture.py", **cfg_overrides):
    return L.lint_source(textwrap.dedent(src), relpath,
                         L.fixture_config(**cfg_overrides))


def _rules(findings):
    return [f.rule for f in findings]


# ===========================================================================
# ESS001: explicit gating argument
# ===========================================================================

def test_ess001_missing_slot_mask():
    fs = _lint("""
        from repro_torch.core import lru_pool as LP
        pool, lk, stats = LP.lookup(pool, ids, valid, 4)
    """)
    assert _rules(fs) == ["ESS001"]
    assert "slot_mask" in fs[0].message


def test_ess001_explicit_none_is_ok():
    fs = _lint("""
        from repro_torch.core import lru_pool as LP
        pool, lk, stats = LP.lookup(pool, ids, valid, 4, slot_mask=None)
        pool = LP.admit(pool, miss, rows, slot_mask=mask)
    """)
    assert fs == []


def test_ess001_direct_import_and_engine_target():
    fs = _lint("""
        from repro_torch.core.offload import host_scatter_rows
        from repro_torch.serving.engine import ess_prefill_chunk
        host_scatter_rows(cache, ids, rows)
        ess_prefill_chunk(params, cfg, toks, pos, caches)
    """)
    assert _rules(fs) == ["ESS001", "ESS001"]
    assert "n_valid" in fs[1].message


def test_ess001_opaque_kwargs_stays_silent():
    fs = _lint("""
        from repro_torch.core import lru_pool as LP
        LP.lookup(pool, ids, valid, 4, **kw)
    """)
    assert fs == []


def test_ess001_local_definition_resolves():
    """Inside ``serving/engine.py`` a bare ``ess_decode(...)`` is the
    module's own target."""
    fs = L.lint_source(textwrap.dedent("""
        def ess_decode(params, cfg, tokens, positions, caches, *,
                       slot_mask=None):
            return caches
        def run(p, c, t, q, k):
            a = ess_decode(p, c, t, q, k)
            return ess_decode(p, c, t, q, k, slot_mask=None)
    """), "src/repro_torch/serving/engine.py",
        L.fixture_config(rules=("ESS001",)))
    assert _rules(fs) == ["ESS001"] and fs[0].scope == "run"


# ===========================================================================
# ESS002: hidden host syncs
# ===========================================================================

def test_ess002_device_get_outside_fetch_site():
    fs = _lint("""
        import torch
        def poll(state):
            torch.cuda.synchronize()
            return state
    """)
    assert _rules(fs) == ["ESS002"]


def test_ess002_allowlisted_fetch_site():
    fs = _lint("""
        class ServeRound:
            def fetch(self, done):
                done.synchronize()
                return self.out
    """, fetch_sites=frozenset(
        {"repro_torch/serving/fixture.py::ServeRound.fetch"}))
    assert fs == []


def test_ess002_cluster_scope_and_pack_site():
    """The cluster package is ESS002-scoped; the real pack wait is the
    only allowlisted wait in it."""
    src = """
        def host_wait(done):
            done.synchronize()
    """
    assert _rules(L.lint_source(textwrap.dedent(src),
                                "repro_torch/cluster/router.py")) \
        == ["ESS002"]
    assert L.lint_source(textwrap.dedent(src),
                         "repro_torch/cluster/kv_transfer.py") == []
    assert C.PACK_WAIT_SITE in C.FETCH_SITES


def test_ess002_item_and_casts():
    fs = _lint("""
        def f(arr, logits, model, x):
            a = arr.item()
            b = int(model(x))
            c = int(arr[0])                  # already host data: fine
            d = int(round(0.5 * len(x)))     # host math: fine
            e = bool(logits.any())
            return a, b, c, d, e
    """)
    assert _rules(fs) == ["ESS002", "ESS002", "ESS002"]
    assert {f.line for f in fs} == {3, 4, 7}


def test_ess002_port_forms():
    """The forms the old ``host_syncs`` found: a pageable ``torch.tensor``
    on a device, ``.tolist()`` / ``.cpu()``, a scalar stored through a
    subscript; ``fill_``, a host-only ``torch.tensor`` and math / numpy
    casts are fine."""
    fs = _lint("""
        import math
        import numpy as np
        import torch
        def step(x, t, n):
            a = torch.tensor(1.0, device=x.device)
            b = torch.tensor([1, 2], dtype=torch.int64)
            c = t.tolist() + [t.cpu()]
            t[0] = -1
            t[1].fill_(-1)
            k = int(math.ceil(n / 3)) + int(np.prod((2, 3)))
            return a, b, c, k
    """)
    assert [f.line for f in fs] == [6, 8, 8, 9]


def test_ess002_host_side_definitions_exempt():
    fs = _lint("""
        def check_consistent(p):
            return p.ids.cpu()
        class ServeSession:
            def _commit(self, t):
                return int(t.sum())
        def step(t):
            return t.item()
    """)
    assert [f.scope for f in fs] == ["step"]


def test_ess002_out_of_scope_module():
    fs = L.lint_source("import torch\ntorch.cuda.synchronize()\n",
                       "repro_torch/launch/time_pages.py")
    assert fs == []


def test_ess002_scope_covers_cluster_and_api():
    mods = {p.relative_to(PKG).as_posix() for p in L.ess002_modules(PKG)}
    assert {"cluster/kv_transfer.py", "cluster/workers.py",
            "cluster/cluster.py", "cluster/router.py",
            "serving/api.py"} <= mods
    # the step modules the old per-module check covered are still in
    assert {"core/lru_pool.py", "serving/engine.py", "serving/step.py",
            "kernels/gather_cache/ops.py",
            "distributed/compression.py"} <= mods
    assert not any(m.startswith(("launch/", "analysis/", "simulator/"))
                   for m in mods)


# ===========================================================================
# suppression + baseline + CLI
# ===========================================================================

def test_inline_disable_suppresses():
    fs = _lint("""
        from repro_torch.core import lru_pool as LP
        LP.lookup(pool, ids, valid, 4)  # esslint: disable=ESS001
    """)
    assert fs == []
    fs2 = _lint("""
        from repro_torch.core import lru_pool as LP
        LP.lookup(pool, ids, valid, 4)  # esslint: disable=ESS002
    """)
    assert _rules(fs2) == ["ESS001"]


def test_disable_on_multiline_call_span():
    fs = _lint("""
        from repro_torch.core import lru_pool as LP
        LP.lookup(pool, ids,
                  valid,  # esslint: disable=ESS001
                  4)
    """)
    assert fs == []


def test_fingerprint_ignores_line_numbers():
    a = Finding("ESS001", "repro_torch/x.py", 10, "f", "m", "LP.lookup(a)")
    b = Finding("ESS001", "repro_torch/x.py", 99, "f", "m", "LP.lookup(a)")
    assert a.fingerprint == b.fingerprint
    assert a != b


def test_baseline_roundtrip_and_split(tmp_path):
    f1 = Finding("ESS001", "repro_torch/a.py", 3, "f", "m", "x()")
    f2 = Finding("ESS002", "repro_torch/b.py", 7, "g", "m", "y()")
    bl = tmp_path / "baseline.json"
    write_baseline(bl, [f1])
    assert load_baseline(bl) == {f1.fingerprint}
    new, known, stale = split_against_baseline([f1, f2],
                                               load_baseline(bl))
    assert new == [f2] and known == [f1] and stale == set()
    new, known, stale = split_against_baseline([f2], load_baseline(bl))
    assert stale == {f1.fingerprint}
    assert load_baseline(tmp_path / "missing.json") == set()


def test_findings_json_shape():
    data = json.loads(findings_to_json(
        [Finding("ESS002", "repro_torch/a.py", 3, "f", "m", "t.item()")]))
    assert data["count"] == 1
    assert data["findings"][0]["rule"] == "ESS002"


def _mini_repo(tmp_path, body):
    mod = tmp_path / "src" / "repro_torch" / "serving" / "engine.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(textwrap.dedent(body))
    return tmp_path, mod


def test_cli_exit_codes(tmp_path, capsys):
    """New finding -> 1; baselined -> 0; fixed (stale) -> 0 with a prune
    hint, 1 under --strict-stale; reintroduced differently -> 1; usage
    errors -> 2; --json writes every finding."""
    root, mod = _mini_repo(tmp_path, """
        def poll(state):
            return state.tok.item()
    """)
    bl = str(tmp_path / "bl.json")
    argv = ["--root", str(root), "--baseline", bl]
    assert cli_main(argv) == 1                       # new finding
    assert cli_main(argv + ["--write-baseline"]) == 0
    assert cli_main(argv) == 0                       # baselined
    out = tmp_path / "f.json"
    assert cli_main(argv + ["--json", str(out)]) == 0
    assert json.loads(out.read_text())["count"] == 1
    mod.write_text("def poll(state):\n    return state\n")
    assert cli_main(argv) == 0                       # clean + stale entry
    assert cli_main(argv + ["--strict-stale"]) == 1
    capsys.readouterr()
    mod.write_text("def poll(state):\n"
                   "    t = state.tok.tolist()\n"
                   "    return t\n")
    assert cli_main(argv) == 1
    assert "ESS002" in capsys.readouterr().out
    assert cli_main(["--root", str(root), "--write-baseline"]) == 2
    with pytest.raises(SystemExit) as e:
        cli_main(["--no-such-flag"])
    assert e.value.code == 2


def test_port_tree_clean_without_baseline(capsys):
    """``python -m repro_torch.analysis`` on the shipped tree: exit 0 with
    no baseline file (inline disables are the only suppressions)."""
    assert L.lint_tree(REPO) == []
    assert cli_main(["--root", str(REPO)]) == 0
    assert "esslint: clean" in capsys.readouterr().out


def test_repo_tree_is_clean_minus_suppressions():
    """Stripping the inline disables resurfaces the acknowledged sites:
    the suppressions are load-bearing, not decorative."""
    found = []
    for rel in ("cluster/kv_transfer.py", "cluster/workers.py"):
        src = (PKG / rel).read_text()
        assert "# esslint: disable=ESS002" in src
        stripped = src.replace("# esslint: disable=ESS002", "#")
        found += L.lint_source(stripped, f"src/repro_torch/{rel}")
    assert _rules(found) == ["ESS002", "ESS002"]
    assert {f.scope for f in found} == {
        "install_migration", "PrefillSessionMixin._finish_prefill"}


# ===========================================================================
# runtime audits: pure checkers and their sabotage cases
# ===========================================================================

def test_fetch_checker_budget_and_total():
    assert A.check_fetch_counts([1, 1, 0, 1], rounds=3) == []
    over = A.check_fetch_counts([2, 1], rounds=3)
    assert "ESS102" in _rules(over)
    mismatch = A.check_fetch_counts([1, 1], rounds=1)
    assert _rules(mismatch) == ["ESS102"]


def test_capture_checker():
    ran = {"decode/greedy", "decode/sampled", "spec/greedy"}
    clean = {k: 1 for k in ran}
    assert A.check_captures(clean, ran, 3, after_first_pass=3) == []
    # sabotage: one key captured twice
    fs = A.check_captures(dict(clean, **{"decode/greedy": 2}), ran, 4)
    assert set(_rules(fs)) == {"ESS103"}
    assert any("captured 2x" in f.message for f in fs)
    # a key that ran compiled but has no graph
    fs = A.check_captures({"decode/greedy": 1}, {"decode/greedy",
                                                 "spec/greedy"}, 1)
    assert any("never captured" in f.message for f in fs)
    # the second pass re-captured
    fs = A.check_captures(clean, ran, 3, after_first_pass=2)
    assert _rules(fs) == ["ESS103"] and "second pass" in fs[0].message
    # an empty run means the driver itself is broken
    assert _rules(A.check_captures({}, set(), 0)) == ["ESS103"]


def test_dtype_checker_flags_drift():
    fs = A.check_state_dtypes("decode", ["state.hidden:bfloat16",
                                         "state.tok:int64"],
                              ["state.hidden:float32", "state.tok:int64"])
    assert _rules(fs) == ["ESS104"]
    assert "bfloat16 -> state.hidden:float32" in fs[0].message
    assert A.check_state_dtypes("d", ["a:bfloat16"], ["a:bfloat16"]) == []
    assert _rules(A.check_state_dtypes("d", ["a:bfloat16"], [])) \
        == ["ESS104"]


def test_tier_dequant_finder_on_profiled_ops():
    """A whole-tier widening (copy or scale multiply) is found; the same
    at gather width, a narrow-only gather and a tier-sized int8 write are
    not."""
    tier = torch.randint(-127, 127, (4, 64, 40), dtype=torch.int8)
    scales = torch.rand(4, 64, 1, dtype=torch.float16)
    ids = torch.tensor([3, 9, 17])
    thr = tier.numel() // tier.shape[0]

    def whole():
        return (tier[1].to(torch.bfloat16) * scales[1])[ids]

    def gathered():
        rows = tier[1][ids]                        # narrow-only gather
        tier[2].copy_(tier[1])                     # int8 -> int8 write
        return rows.to(torch.bfloat16) * scales[1][ids]

    _, ops = A.profile_round(whole)
    hits = A.find_tier_dequants(ops, thr)
    assert hits and all(h[1] >= thr and h[2] == "int8" for h in hits)
    fs = A.check_tier_dequants("int8", hits, thr)
    assert set(_rules(fs)) == {"ESS106"}
    _, ops = A.profile_round(gathered)
    assert ops and A.find_tier_dequants(ops, thr) == []


def test_migration_pack_checker():
    clean = A.check_migration_packs([1, 1], {0: 1, 1: 1}, [0, 0],
                                    [1, 1, 0], 2, install_waits=(0, 0))
    assert clean == []
    over = A.check_migration_packs([2], {0: 1}, [0], [1], 1)
    assert _rules(over) == ["ESS107"]
    assert "ONE packed fetch" in over[0].message
    twice = A.check_migration_packs([1, 1], {0: 2}, [0], [1, 1], 2)
    assert _rules(twice) == ["ESS107"]
    leak = A.check_migration_packs([1], {0: 1}, [2], [1], 1)
    assert _rules(leak) == ["ESS107"]
    smug = A.check_migration_packs([1], {0: 1}, [0], [2], 2)
    assert _rules(smug) == ["ESS107"]
    inst = A.check_migration_packs([1], {0: 1}, [0], [1], 1,
                                   install_waits=(1,))
    assert _rules(inst) == ["ESS107"] and "install" in inst[0].message
    stray = A.check_migration_packs([1], {0: 1}, [0], [1], 1, stray=3)
    assert _rules(stray) == ["ESS107"]
    assert "outside any worker round" in stray[0].message


# ===========================================================================
# runtime audits: the drivers on CPU smoke sessions and a CPU cluster
# ===========================================================================

@pytest.fixture(scope="module")
def watched():
    """The mixed workload through two CPU sessions, each shared by the
    ESS102 / ESS104 / ESS106 cases: a bf16 Q = 1 synchronous session, and
    an int8 MTP depth-2 pipelined one with its first decode round
    profiled eager."""
    return {
        "q1": A.audit_session(A.smoke_session(device="cpu"), name="q1"),
        "int8+mtp2+pipelined": A.audit_session(
            A.smoke_session(A.smoke_cfg("int8"), device="cpu", mtp_depth=2,
                            overlap=True),
            name="int8", profile_decode=0)}


@pytest.fixture(scope="module")
def watched_cluster():
    return A.audit_cluster(A.smoke_cluster(device="cpu"))


@pytest.mark.parametrize("name", ["q1", "int8+mtp2+pipelined"])
def test_fetch_golden_real_session(watched, name):
    """ESS102 end to end: greedy and sampled rounds, Q = 1 and MTP depth
    2, synchronous and pipelined; one fetch every stepped round."""
    w = watched[name]
    assert [f for f in w.findings() if f.rule == "ESS102"] == []
    c = w.counts()
    assert c["rounds"] > 0 and c["fetches"] == c["rounds"]
    assert c["max_fetches_a_round"] == 1
    assert w.session.report.finished_rids == [0, 1, 2, 3]


@pytest.mark.parametrize("name", ["q1", "int8+mtp2+pipelined"])
def test_state_dtypes_golden_real_session(watched, name):
    """ESS104: every EngineState tensor keeps its dtype, bf16 and int8
    tiers alike (the pipelined session's slab included)."""
    w = watched[name]
    assert [f for f in w.findings() if f.rule == "ESS104"] == []
    leaves = dict(p.split(":") for p in A.state_dtypes(w.session.state))
    assert leaves["state.caches.host_latent"] == (
        "int8" if name.startswith("int8") else "bfloat16")
    if name.startswith("int8"):
        assert leaves["state.staged_rows"] == "int8"


def test_tier_dequant_golden_int8_round(watched):
    """ESS106 on the int8 session's eager decode round: ops profiled,
    none widens a tier-sized narrow tensor."""
    w = watched["int8+mtp2+pipelined"]
    assert w.profiled_ops and len(w.profiled_ops) > 100
    assert [f for f in w.findings() if f.rule == "ESS106"] == []


def test_tier_dequant_golden_fp8_round():
    w = A.audit_session(A.smoke_session(A.smoke_cfg("fp8"), device="cpu"),
                        short(), name="fp8", profile_decode=0)
    assert w.profiled_ops and w.findings() == []


def test_fetch_audit_catches_leaky_session():
    """A session that fetches twice a round is caught (ESS102)."""
    class LeakySession(TE.ServeSession):
        def decode_round(self):
            done = super().decode_round()
            TE.device_get([self.state.tok])          # the smuggled fetch
            return done

    w = A.audit_session(A.smoke_session(device="cpu",
                                        session_cls=LeakySession), short())
    fs = w.findings()
    assert fs and all(f.rule == "ESS102" for f in fs)


def test_dtype_audit_catches_widened_leaf():
    """A session that rebinds a state leaf widened to f32 is caught
    (ESS104)."""
    class WideningSession(TE.ServeSession):
        def step_round(self):
            evs = super().step_round()
            if not (self.sched.running or self.sched.queue):
                self.state = self.state._replace(
                    hidden=self.state.hidden.float())
            return evs

    w = A.audit_session(A.smoke_session(device="cpu",
                                        session_cls=WideningSession), short())
    fs = w.findings()
    assert _rules(fs) == ["ESS104"]
    assert "state.hidden:bfloat16 -> state.hidden:float32" in fs[0].message


def test_tier_dequant_audit_catches_whole_tier_dequant(monkeypatch):
    """A round that dequantizes the whole tier before its gather is caught
    (ESS106)."""
    def dequant_then_gather(cache, scales, ids, out_dtype=torch.bfloat16,
                            **kw):
        wide = cache.to(out_dtype) * scales.to(out_dtype)   # whole tier
        rows = wide[ids.clamp_min(0)]
        return torch.where((ids >= 0)[..., None], rows, 0)

    monkeypatch.setattr(gops, "gather_rows_dequant", dequant_then_gather)
    w = A.audit_session(A.smoke_session(A.smoke_cfg("int8"), device="cpu"),
                        short(), name="int8", profile_decode=0)
    fs = w.findings()
    assert fs and set(_rules(fs)) == {"ESS106"}


def test_migration_pack_golden_cluster(watched_cluster):
    """ESS107 end to end: one wait a pack, each rid packed once, prefill
    rounds wait only to pack, decode rounds within ESS102, no wait in an
    install."""
    w = watched_cluster
    assert w.findings() == []
    c = w.counts()
    assert c["packs"] == 4 and c["waits_per_pack"] == [1]
    assert c["installs"] == 4 and c["install_waits"] == 0
    assert c["decode_rounds"] > 0 and c["decode_fetches"] == \
        c["decode_rounds"]


def test_migration_pack_audit_catches_smuggled_fetch():
    """A decode-worker session smuggling a second fetch into its round is
    caught (ESS107)."""
    class SmugglerSession(TE.ServeSession):
        def step_round(self):
            evs = super().step_round()
            TE.device_get([self.state.tok])          # the smuggled fetch
            return evs

    w = A.audit_cluster(A.smoke_cluster(device="cpu",
                                        decode_session_cls=SmugglerSession),
                        short())
    fs = w.findings()
    assert fs and all(f.rule == "ESS107" for f in fs)


def test_migration_pack_audit_catches_pack_with_second_wait(monkeypatch):
    """A cluster whose pack smuggles a second wait is caught (ESS107)."""
    real = TKT.pack_migration

    def pack_twice(session, slot, req, t0, **kw):
        pkt = real(session, slot, req, t0, **kw)
        TKT.host_wait(session.device)                # the smuggled wait
        return pkt

    monkeypatch.setattr(TKT, "pack_migration", pack_twice)
    w = A.audit_cluster(A.smoke_cluster(device="cpu"), short())
    fs = w.findings()
    assert fs and all(f.rule == "ESS107" for f in fs)
    assert any("ONE packed fetch" in f.message for f in fs)


def test_audit_drivers_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        A.smoke_session()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        A.smoke_cluster()


def test_capture_audit_needs_the_card():
    """On the CPU the round runs eager: the watch records no compiled key
    and skips ESS103 (its checker runs above, the card case in
    ``test_torch_cuda.py``)."""
    s = A.smoke_session(device="cpu")
    assert s.compiled is False
    with pytest.raises(ValueError, match="compiled=False on the CPU"):
        s.programs.decode(True)(s.params, s.state, s._out)


def test_contracts_name_live_sites():
    """Every site the contracts name exists in the port's tree."""
    import importlib
    for site in C.FETCH_SITES | {C.PACK_SITE, *C.INSTALL_SITES}:
        path, qual = site.split("::")
        mod = importlib.import_module(path[:-3].replace("/", "."))
        obj = mod
        for part in qual.split("."):
            obj = getattr(obj, part)
        assert callable(obj), site
    for target in C.ESS001_TARGETS:
        mod, _, fn = target.rpartition(".")
        assert callable(getattr(importlib.import_module(mod), fn)), target
    assert dataclasses.is_dataclass(Finding)
