"""The port's serve contracts, under the reference's rule names — the one
table the lint (:mod:`repro_torch.analysis.lint`), the runtime audits
(:mod:`repro_torch.analysis.audit`), their tests and ``chip_smoke.py``
read (counterpart of ``repro.analysis.contracts``).

The reference's ESS003 (Python branching on traced values) and ESS004
(undeclared donation) have no meaning in eager torch and are not ported;
its ESS101 (donation) and ESS105 (the slab refill off the token path,
read from a jaxpr slice) have no jaxpr to read here.  ESS103's retrace
budget becomes a capture budget: a round variant is a CUDA graph.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# One-fetch contract (ESS102, ESS002)
# ---------------------------------------------------------------------------

# Host fetches (``engine.device_get`` calls) per serve round.  A round's
# one fetch is the commit stage's packed RoundOut plus the just-promoted
# slots' first tokens: one non-blocking copy into a pinned buffer and one
# event wait.  Plan and compute, prefill chunks, admissions and the
# scheduler's bookkeeping wait for nothing.  The pipelined round's slab
# refill runs on the fetch stream inside the round's graph, so it adds no
# host wait.
FETCH_BUDGET_PER_ROUND = 1

# The functions that may wait for the card ("<module path>::<qualname>",
# ESS002): the round's fetch and the PD pack's one wait.  Any other wait
# in an ESS002-scoped module needs ``# esslint: disable=ESS002`` with its
# reason.
FETCH_SITE = "repro_torch/serving/engine.py::device_get"
PACK_WAIT_SITE = "repro_torch/cluster/kv_transfer.py::host_wait"
FETCH_SITES = {FETCH_SITE, PACK_WAIT_SITE}

# ---------------------------------------------------------------------------
# Capture budget (ESS103)
# ---------------------------------------------------------------------------

# The session's round kinds.  A compiled session replays "decode" and
# "spec" rounds as CUDA graphs, one graph per (kind, sampled) key,
# captured once however the workload interleaves admissions, preemptions
# and ragged chunks; "prefill" chunks run eagerly and are not counted.
ROUND_KINDS = ("decode", "spec", "prefill")

# ---------------------------------------------------------------------------
# Dtype contract (ESS104)
# ---------------------------------------------------------------------------

# Every tensor of a session's EngineState keeps the dtype it was built
# with: the round updates the state in place, so a drifted leaf is a
# rebound tensor (a graph replay would read the old one) or a widened
# cache.

# ---------------------------------------------------------------------------
# ESS001: cache-mutating helpers take their gating argument explicitly
# ---------------------------------------------------------------------------

# qualified callee -> keyword that must be spelled at the call (None is an
# accepted explicit value: the rule bans relying on a default, not the
# ungated mode itself)
ESS001_TARGETS = {
    "repro_torch.core.offload.host_scatter_rows": "slot_mask",
    "repro_torch.core.offload.host_scatter_rows_stacked": "slot_mask",
    "repro_torch.core.offload.gather_into_slab": "slot_mask",
    "repro_torch.core.offload.scatter_from_slab": "slot_mask",
    "repro_torch.core.offload.scatter_tier_rows": "slot_mask",
    "repro_torch.core.offload.scatter_tier_rows_stacked": "slot_mask",
    "repro_torch.core.lru_pool.lookup": "slot_mask",
    "repro_torch.core.lru_pool.admit": "slot_mask",
    "repro_torch.core.warmup.lru_warmup": "slot_mask",
    "repro_torch.serving.engine.ess_decode": "slot_mask",
    "repro_torch.serving.engine.ess_prefill_chunk": "n_valid",
}

# ---------------------------------------------------------------------------
# ESS002 scope: the modules a round, a prefill chunk, a pack or an install
# runs through (fnmatch patterns over repo paths from ``repro_torch/``)
# ---------------------------------------------------------------------------

ESS002_MODULES = (
    "repro_torch/core/*.py",
    "repro_torch/models/*.py",
    "repro_torch/kernels/*/ops.py",
    "repro_torch/cache/latent_cache.py",
    "repro_torch/distributed/compression.py",
    "repro_torch/serving/engine.py",
    "repro_torch/serving/mtp.py",
    "repro_torch/serving/prng.py",
    "repro_torch/serving/sampling.py",
    "repro_torch/serving/state.py",
    "repro_torch/serving/step.py",
    "repro_torch/serving/tbo.py",
    "repro_torch/serving/api.py",
    "repro_torch/cluster/*.py",
)

# Top-level definitions that are host code by design, exempt as a whole:
# the pool's invariant check (tests, debugging), the fixed-batch entry
# point's report, and the session's methods around the rounds (its one
# fetch is ``device_get``).
ESS002_HOST_SIDE = frozenset({"check_consistent", "generate_batch",
                              "ServeSession"})

# ---------------------------------------------------------------------------
# ESS106: a quantized tier dequantizes at gather width only
# ---------------------------------------------------------------------------

# With an int8 / fp8 host tier no op of a round may take a tier-sized
# narrow tensor (one layer's tier view or more) and widen it: the dequant
# happens after the gather, at miss / slab width.
ESS106_NARROW_DTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")
ESS106_WIDE_DTYPES = ("bfloat16", "float16", "float32")

# ---------------------------------------------------------------------------
# ESS107: one host wait per PD migration, none per install
# ---------------------------------------------------------------------------

# A prefill -> decode handoff serializes a promoted slot once:
# ``kv_transfer.pack_migration`` enqueues the page gather into the pinned
# packet and the copies of keys, hidden and first token, then makes ONE
# host wait (``host_wait``).  The page inventory comes from the host-side
# allocator.  ``install_migration`` (and ``DecodeWorker.install``) waits
# for nothing, and a decode worker's rounds keep FETCH_BUDGET_PER_ROUND.
PACK_BUDGET_PER_MIGRATION = 1
PACK_SITE = "repro_torch/cluster/kv_transfer.py::pack_migration"
INSTALL_SITES = ("repro_torch/cluster/kv_transfer.py::install_migration",
                 "repro_torch/cluster/workers.py::DecodeWorker.install")
