"""Runtime audits of the port's serve contracts
(:mod:`repro_torch.analysis.contracts`; counterpart of
``repro.analysis.jaxpr_audit``).  There is no jaxpr to lower in eager
torch, so each audit watches a real workload: a pure checker over plain
counts (tests feed it sabotaged data) beside a driver.

* **ESS102 fetches a round** — every serve round (``step_round``) calls
  ``engine.device_get`` at most :data:`~contracts.FETCH_BUDGET_PER_ROUND`
  times, and the calls add up to ``report.rounds``.
* **ESS103 the capture budget** — a compiled session captures one CUDA
  graph per ``(round kind, sampled)`` key that ran, and no more over a
  second pass of the same workload: ``StepPrograms.captures`` equals the
  distinct keys.  Prefill chunks run eagerly and are not counted.  Needs
  the card (``compiled=True``); on the CPU only the checker runs.
* **ESS104 state dtype drift** — every tensor of the session's
  :class:`~repro_torch.serving.state.EngineState` has the dtype it was
  built with after the workload.
* **ESS106 no tier-width dequant** — an eager round of a session with an
  int8 / fp8 tier, profiled with ``torch.profiler`` (``record_shapes``):
  no op takes a narrow tensor of at least one layer's tier elements
  together with a bf16 / f16 / f32 tensor (a widening copy, a scale
  multiply over the whole tier).  A graph replay hides its ops, so the
  profiled round runs eager.  A session whose state holds no int8 / fp8
  tensor is not profiled: it is flagged, as the reference flags a bf16
  tier ("no quantized state leaf").
* **ESS107 the PD pack** — a 1-prefill + 1-decode
  :class:`~repro_torch.cluster.EssCluster`: each ``pack_migration``
  makes exactly :data:`~contracts.PACK_BUDGET_PER_MIGRATION` host wait,
  each rid packs once, prefill rounds wait only to pack, decode rounds
  keep ESS102, installs wait for nothing, and nothing waits outside a
  worker round.

A host wait is a call of ``engine.device_get`` (the round's fetch) or
``kv_transfer.host_wait`` (the pack's).  The drivers run on the card by
default and raise without one unless given ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch.analysis import contracts as C
from repro_torch.analysis.findings import Finding

SMOKE_CONFIG = "deepseek-v32-exp-ess-smoke"
AUDIT_PATH = "<runtime>"
AUDIT_MAX_SEQ = 32


def _finding(rule: str, scope: str, message: str) -> Finding:
    return Finding(rule=rule, path=AUDIT_PATH, line=0, scope=scope,
                   message=message)


def smoke_cfg(host_dtype: str = "bf16", mtp_depth: int = 2):
    """The smoke config as the reference's audits take it: the miss
    envelope unbound, two stacked MTP modules.  With an int8 / fp8 tier
    the latent widens from 32 + 8 to 40 + 8 values: the card's row
    gathers move 16-byte multiples, one byte a value."""
    from repro_torch.configs import get_config
    cfg = get_config(SMOKE_CONFIG)
    ess = dataclasses.replace(cfg.ess, max_miss_ratio=1.0,
                              host_cache_dtype=host_dtype)
    cfg = dataclasses.replace(cfg, ess=ess, mtp_depth=mtp_depth)
    if host_dtype != "bf16":
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, kv_lora_rank=40))
    return cfg


def mixed_requests():
    """The reference's ``jaxpr_audit._mixed_requests``: three greedy
    requests and one sampled, ragged prompts."""
    from repro_torch.serving.scheduler import Request
    return [Request(rid=0, prompt_len=11, max_new_tokens=5),
            Request(rid=1, prompt_len=8, max_new_tokens=4),
            Request(rid=2, prompt_len=9, max_new_tokens=3,
                    temperature=0.9, seed=5),
            Request(rid=3, prompt_len=10, max_new_tokens=4)]


def again(requests, rid0: int):
    """The same requests under fresh rids ``rid0, rid0 + 1, ...``, for a
    second pass of a workload."""
    from repro_torch.serving.scheduler import Request
    return [Request(rid=rid0 + i, prompt_len=r.prompt_len,
                    max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
                    seed=r.seed, eos_token_ids=r.eos_token_ids,
                    stop_token_ids=r.stop_token_ids, priority=r.priority)
            for i, r in enumerate(requests)]


def _patch(stack: contextlib.ExitStack, obj, name: str, new) -> None:
    """Set ``obj.name = new`` until ``stack`` closes (an instance
    attribute it shadowed, or none, comes back)."""
    had = name in vars(obj)
    old = vars(obj).get(name)
    setattr(obj, name, new)

    def undo():
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)
    stack.callback(undo)


def _count_calls(stack: contextlib.ExitStack, module, name: str,
                 counter: list) -> None:
    """Count the calls of ``module.name`` (calling through) until
    ``stack`` closes."""
    real = getattr(module, name)

    def counted(*a, **k):
        counter[0] += 1
        return real(*a, **k)

    _patch(stack, module, name, counted)


# ---------------------------------------------------------------------------
# ESS102: one fetch per round
# ---------------------------------------------------------------------------

def check_fetch_counts(per_round: list[int], rounds: int,
                       budget: int = C.FETCH_BUDGET_PER_ROUND
                       ) -> list[Finding]:
    """Pure checker over per-serve-round ``device_get`` counts."""
    out = []
    for i, n in enumerate(per_round):
        if n > budget:
            out.append(_finding(
                "ESS102", f"round[{i}]",
                f"{n} device->host fetches in one serve round "
                f"(budget {budget})"))
    total = sum(per_round)
    if total != rounds:
        out.append(_finding(
            "ESS102", "total",
            f"{total} fetches over {rounds} decode rounds — the packed "
            f"RoundOut fetch must be the only transfer (expected exactly "
            f"{rounds})"))
    return out


# ---------------------------------------------------------------------------
# ESS103: capture budget
# ---------------------------------------------------------------------------

def check_captures(captures_by_key: dict[str, int], ran: set,
                   captures: int, after_first_pass: Optional[int] = None
                   ) -> list[Finding]:
    """Pure checker: graphs captured per ``kind/sampled`` key, the keys
    whose compiled rounds ran, ``StepPrograms.captures`` at the end and,
    given, after the first pass of the workload."""
    if not ran:
        return [_finding("ESS103", "driver",
                         "no compiled round ran — audit drove nothing")]
    out = []
    for key, n in sorted(captures_by_key.items()):
        if n != 1:
            out.append(_finding(
                "ESS103", key,
                f"captured {n}x (expected once): a capture per round is a "
                f"silent re-record in production"))
    for key in sorted(set(ran) - set(captures_by_key)):
        out.append(_finding("ESS103", key,
                            "ran as a compiled round but never captured"))
    if captures != len(ran):
        out.append(_finding(
            "ESS103", "total",
            f"StepPrograms.captures {captures} != {len(ran)} distinct "
            f"round keys that ran"))
    if after_first_pass is not None and captures != after_first_pass:
        out.append(_finding(
            "ESS103", "second_pass",
            f"captures moved {after_first_pass} -> {captures} over a "
            f"second pass of the same workload"))
    return out


# ---------------------------------------------------------------------------
# ESS104: state dtype drift
# ---------------------------------------------------------------------------

def state_leaves(tree, path: str = "state") -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every tensor in an EngineState-like tree
    (named tuples, lists, tuples; None skipped)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in state_leaves(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, x in enumerate(tree)
                for leaf in state_leaves(x, f"{path}[{i}]")]
    return []


def state_dtypes(state) -> list[str]:
    return [f"{p}:{str(t.dtype).removeprefix('torch.')}"
            for p, t in state_leaves(state)]


def check_state_dtypes(kind: str, in_dtypes: list, out_dtypes: list
                       ) -> list[Finding]:
    """Pure checker: per-leaf dtypes at construction vs after the
    workload (the reference's, same messages)."""
    out = []
    if len(in_dtypes) != len(out_dtypes):
        return [_finding("ESS104", kind,
                         f"{kind}: state leaf count changed "
                         f"{len(in_dtypes)} -> {len(out_dtypes)}")]
    for i, (a, b) in enumerate(zip(in_dtypes, out_dtypes)):
        if a != b:
            out.append(_finding(
                "ESS104", kind,
                f"{kind}: state leaf[{i}] dtype drifts {a} -> {b} across "
                f"the round"))
    return out


# ---------------------------------------------------------------------------
# ESS106: quantized tier dequantizes at gather width only
# ---------------------------------------------------------------------------

def _cpu_ops(prof) -> list:
    """The CPU op events of a ``torch.profiler`` run, as the profiler's own
    records (their ``shapes()`` and ``dtypes()`` are there on every torch
    that records shapes)."""
    from torch.autograd import DeviceType
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


@functools.cache
def _profiler_dtype_names() -> dict[str, str]:
    """The profiler's type strings (``record_shapes``) -> dtype names,
    read off the running torch."""
    from torch.profiler import ProfilerActivity, profile
    names = C.ESS106_NARROW_DTYPES + C.ESS106_WIDE_DTYPES
    xs = [torch.zeros(1, dtype=getattr(torch, n)) for n in names]
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for x in xs:
            x.clone()
    seen = [e.dtypes()[0] for e in _cpu_ops(prof)
            if e.name() == "aten::clone"]
    return dict(zip(seen, names))


def profiled_ops(prof) -> list[tuple[str, list, list]]:
    """``(name, input shapes, input dtype names)`` of every CPU op a
    ``torch.profiler`` run (``record_shapes=True``) recorded."""
    names = _profiler_dtype_names()
    return [(e.name(), list(e.shapes()),
             [names.get(d, d) for d in e.dtypes()]) for e in _cpu_ops(prof)]


def _numel(shape) -> int:
    n = 1
    for s in shape if isinstance(shape, (list, tuple)) else ():
        if not isinstance(s, int):
            return 0
        n *= s
    return n


def find_tier_dequants(ops, threshold: int) -> list[tuple]:
    """``(op, size, narrow dtype, wide dtype)`` for each op that takes a
    narrow (int8 / fp8) tensor of ``>= threshold`` elements together with
    a wide (bf16 / f16 / f32) tensor: a widening copy or a dequant over
    the tier."""
    hits = []
    for name, shapes, dtypes in ops:
        narrow = [(_numel(s), d) for s, d in zip(shapes, dtypes)
                  if d in C.ESS106_NARROW_DTYPES and s]
        wide = [d for s, d in zip(shapes, dtypes)
                if d in C.ESS106_WIDE_DTYPES and isinstance(s, list)]
        big = [(n, d) for n, d in narrow if n >= threshold]
        if big and wide:
            hits.append((name, big[0][0], big[0][1], wide[0]))
    return hits


def check_tier_dequants(kind: str, hits: list[tuple],
                        threshold: int) -> list[Finding]:
    """Pure checker over one round's tier-sized dequant hits."""
    return [_finding(
        "ESS106", kind,
        f"{kind}: {op} widens {sd} -> {dd} on a cache-tier-sized tensor "
        f"({size} >= {threshold} elements) — the quantized tier must "
        f"dequantize at gather width, never materialize decompressed")
        for op, size, sd, dd in hits]


def tier_threshold(state) -> int:
    """One layer's tier elements: the narrowest whole-tier view a round
    could widen."""
    host = state.caches.host_latent
    return host.numel() // host.shape[0]


def profile_round(fn: Callable) -> tuple:
    """Run ``fn`` under ``torch.profiler`` (CPU ops, shapes and dtypes);
    returns ``(fn's result, profiled_ops)``."""
    from torch.profiler import ProfilerActivity, profile
    _profiler_dtype_names()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        out = fn()
    return out, profiled_ops(prof)


# ---------------------------------------------------------------------------
# watching a session: ESS102 / ESS103 / ESS104 / ESS106
# ---------------------------------------------------------------------------

class SessionWatch:
    """Instrument one :class:`~repro_torch.serving.engine.ServeSession`
    for ESS102-ESS106 while open (``with SessionWatch(s) as w:``, as often
    as needed; the counts accumulate): the
    ``device_get`` calls of each ``step_round``, the ``(kind, sampled)``
    key of each compiled round and the captures each key made, the state
    dtypes at attach, and, with ``profile_decode`` (the index of a decode
    round among those that step), that round run eager under the
    profiler.  The session itself is untouched; wrappers already on it
    (timing, sync checks) stay inside."""

    def __init__(self, session, *, name: str = "session",
                 profile_decode: Optional[int] = None):
        self.session = session
        self.name = name
        self.per_round: list[int] = []
        self.ran: set = set()
        self.captures_by_key: dict[str, int] = {}
        self.dtypes_in = state_dtypes(session.state)
        self.rounds0 = session.report.rounds
        self.captures0 = session.programs.captures
        self.first_pass_captures: Optional[int] = None
        self.profile_decode = profile_decode
        self.profiled_ops: Optional[list] = None
        self.threshold = tier_threshold(session.state)
        # ESS106 audits a quantized tier; a session without one is flagged
        # instead of profiled (the reference's "no quantized state leaf")
        self.quantized = any(
            str(t.dtype).removeprefix("torch.") in C.ESS106_NARROW_DTYPES
            for _, t in state_leaves(session.state))
        self._fetches = [0]
        self._stack = None

    # -- instrumentation ----------------------------------------------------

    def __enter__(self) -> "SessionWatch":
        from repro_torch.serving import engine as E
        s, progs = self.session, self.session.programs
        self._stack = contextlib.ExitStack()
        _count_calls(self._stack, E, "device_get", self._fetches)
        for obj, name, make in (
                (s, "step_round", self._step_round),
                (s, "_compute_round", self._compute_round),
                (s, "decode_round", self._decode_round),
                (progs, "_replay", self._replay),
                (progs, "_capture", self._capture)):
            _patch(self._stack, obj, name, make(getattr(obj, name)))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()

    def _step_round(self, real):
        def step_round(*a, **k):
            n0 = self._fetches[0]
            out = real(*a, **k)
            self.per_round.append(self._fetches[0] - n0)
            return out
        return step_round

    def _compute_round(self, real):
        def compute(plan):
            if self.session.compiled:
                self.ran.add(self._key(plan.spec, plan.sampled))
            return real(plan)
        return compute

    def _decode_round(self, real):
        def decode_round(*a, **k):
            k_round = self.session.report.rounds - self.rounds0
            if k_round != self.profile_decode or not self.quantized \
                    or self.profiled_ops is not None \
                    or not self.session.sched.active_slots():
                return real(*a, **k)
            compiled = self.session.compiled
            self.session.compiled = False        # an eager round: ops seen
            try:
                out, self.profiled_ops = profile_round(lambda: real(*a, **k))
            finally:
                self.session.compiled = compiled
            return out
        return decode_round

    @staticmethod
    def _key(spec: bool, sampled: bool) -> str:
        return f"{'spec' if spec else 'decode'}/" \
            f"{'sampled' if sampled else 'greedy'}"

    def _replay(self, real):
        def replay(key, *a, **k):
            self._current = self._key(*key)
            try:
                return real(key, *a, **k)
            finally:
                self._current = None
        return replay

    def _capture(self, real):
        def capture(*a, **k):
            key = getattr(self, "_current", None) or "unknown"
            self.captures_by_key[key] = self.captures_by_key.get(key, 0) + 1
            return real(*a, **k)
        return capture

    # -- driving --------------------------------------------------------------

    def drive(self, requests, *, max_rounds: int = 200):
        """``session.run(requests)``; a second call is the second pass
        (ESS103 checks the captures did not move)."""
        if self.per_round and self.first_pass_captures is None:
            self.first_pass_captures = self.session.programs.captures
        return self.session.run(requests, max_rounds=max_rounds)

    # -- verdicts -------------------------------------------------------------

    def counts(self) -> dict:
        """What the audits read, for a log line."""
        s = self.session
        rounds = s.report.rounds - self.rounds0
        return dict(rounds=rounds, fetches=sum(self.per_round),
                    max_fetches_a_round=max(self.per_round, default=0),
                    captures=s.programs.captures - self.captures0,
                    round_keys=sorted(self.ran),
                    captures_by_key=dict(sorted(
                        self.captures_by_key.items())),
                    profiled_ops=(None if self.profiled_ops is None
                                  else len(self.profiled_ops)))

    def findings(self) -> list[Finding]:
        s = self.session
        fs = check_fetch_counts(self.per_round,
                                s.report.rounds - self.rounds0)
        if s.compiled:
            fs += check_captures(
                self.captures_by_key, self.ran,
                s.programs.captures - self.captures0,
                None if self.first_pass_captures is None
                else self.first_pass_captures - self.captures0)
        fs += check_state_dtypes(self.name, self.dtypes_in,
                                 state_dtypes(s.state))
        if self.profile_decode is not None:
            if not self.quantized:
                fs.append(_finding(
                    "ESS106", self.name,
                    f"{self.name}: no quantized state leaf — audit the "
                    f"quantized tier config (host_cache_dtype)"))
            elif self.profiled_ops is None:
                fs.append(_finding("ESS106", self.name,
                                   "the decode round to profile never ran"))
            else:
                fs += check_tier_dequants(
                    self.name, find_tier_dequants(self.profiled_ops,
                                                  self.threshold),
                    self.threshold)
        return [dataclasses.replace(f, scope=f"{self.name}/{f.scope}")
                for f in fs]


def smoke_session(cfg=None, *, device=None, session_cls=None,
                  compiled: Optional[bool] = None, **session_kw):
    """A smoke-config ``ServeSession`` of two slots over random weights
    (seed 0) on ``device`` (the card by default); compiled on the card."""
    from repro_torch import resolve_device
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = cfg if cfg is not None else smoke_cfg()
    dev = resolve_device(device)
    params = init_params(cfg, 0, device=dev)
    cls = session_cls or E.ServeSession
    session_kw.setdefault("max_seq", AUDIT_MAX_SEQ)
    return cls(params, cfg, num_slots=2, prefill_chunk=8,
               compiled=dev.type == "cuda" if compiled is None else compiled,
               device=dev, **session_kw)


def audit_session(session, requests=None, *, name: str = "session",
                  passes: int = 1, profile_decode: Optional[int] = None
                  ) -> SessionWatch:
    """Drive ``requests`` (the mixed workload by default) through
    ``session`` ``passes`` times under a :class:`SessionWatch`; returns
    the (closed) watch: ``.findings()``, ``.counts()``."""
    requests = requests if requests is not None else mixed_requests()
    rid0 = max(r.rid for r in requests) + 1
    with SessionWatch(session, name=name,
                      profile_decode=profile_decode) as w:
        for p in range(passes):
            w.drive(requests if p == 0 else again(requests, rid0 * p))
    return w


# ---------------------------------------------------------------------------
# ESS107: one host wait per PD migration
# ---------------------------------------------------------------------------

def check_migration_packs(pack_fetches: list[int],
                          packs_per_rid: dict[int, int],
                          prefill_extra: list[int],
                          decode_counts: list[int], decode_rounds: int,
                          stray: int = 0,
                          budget: int = C.PACK_BUDGET_PER_MIGRATION,
                          install_waits: tuple = ()) -> list[Finding]:
    """Pure checker over the host waits of one PD cluster run: every pack
    is exactly ``budget`` waits, every migrated rid packs once, prefill
    rounds wait only to pack, decode rounds keep the one-fetch round
    budget, installs wait for nothing, and nothing waits outside a worker
    round."""
    out = []
    for i, n in enumerate(pack_fetches):
        if n != budget:
            out.append(_finding(
                "ESS107", f"pack[{i}]",
                f"{n} host waits in one migration pack (budget {budget}: "
                f"pages + scales + ikeys + hidden + t0 ride ONE packed "
                f"fetch)"))
    for rid, n in sorted(packs_per_rid.items()):
        if n != 1:
            out.append(_finding(
                "ESS107", f"rid[{rid}]",
                f"rid={rid} packed {n} times — one handoff per migration"))
    for i, n in enumerate(prefill_extra):
        if n > 0:
            out.append(_finding(
                "ESS107", f"prefill_round[{i}]",
                f"{n} host waits outside the pack site in a prefill worker "
                f"round — prefill fetches only to pack"))
    for f in check_fetch_counts(decode_counts, decode_rounds):
        out.append(dataclasses.replace(
            f, rule="ESS107", scope=f"decode_{f.scope}"))
    for i, n in enumerate(install_waits):
        if n:
            out.append(_finding(
                "ESS107", f"install[{i}]",
                f"{n} host waits in one install — the install is enqueued "
                f"on the decode stream and waits for nothing"))
    if stray:
        out.append(_finding(
            "ESS107", "cluster",
            f"{stray} device->host fetches outside any worker round "
            f"(placement/install must perform zero fetches — the first "
            f"token rides the packet)"))
    return out


class ClusterWatch:
    """Instrument an :class:`~repro_torch.cluster.EssCluster` for ESS107
    while open: host waits (``device_get`` + ``host_wait``) inside each
    ``pack_migration``, each prefill and decode worker round and each
    install, and outside them all."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.pack_waits: list[int] = []
        self.packs_per_rid: dict[int, int] = {}
        self.prefill_extra: list[int] = []
        self.decode_counts: list[int] = []
        self.install_waits: list[int] = []
        self.rounds0 = self._decode_rounds()
        self.finished = True            # a driver's verdict on its workload
        self._waits = [0]
        self._stack = contextlib.ExitStack()

    def _decode_rounds(self) -> int:
        return sum(w.session.report.rounds for w in self.cluster.decode)

    def __enter__(self) -> "ClusterWatch":
        from repro_torch.cluster import kv_transfer as KT
        from repro_torch.serving import engine as E
        st = self._stack
        _count_calls(st, E, "device_get", self._waits)
        _count_calls(st, KT, "host_wait", self._waits)
        real_pack = KT.pack_migration

        def pack(session, slot, req, t0, **kw):
            n0 = self._waits[0]
            pkt = real_pack(session, slot, req, t0, **kw)
            self.pack_waits.append(self._waits[0] - n0)
            self.packs_per_rid[req.rid] = \
                self.packs_per_rid.get(req.rid, 0) + 1
            return pkt

        _patch(st, KT, "pack_migration", pack)
        for w in self.cluster.prefill:
            self._bracket(w, "step", lambda n, packed:
                          self.prefill_extra.append(n - packed))
        for w in self.cluster.decode:
            self._bracket(w, "step", lambda n, _: self.decode_counts.append(n))
            self._bracket(w, "install", lambda n, _:
                          self.install_waits.append(n))
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()

    def _bracket(self, w, name: str, record: Callable) -> None:
        """Wrap ``w.name``: ``record(waits inside, of them in packs)``."""
        real = getattr(w, name)

        def wrapped(*a, **k):
            n0, npk = self._waits[0], len(self.pack_waits)
            out = real(*a, **k)
            record(self._waits[0] - n0, sum(self.pack_waits[npk:]))
            return out

        _patch(self._stack, w, name, wrapped)

    def counts(self) -> dict:
        return dict(packs=len(self.pack_waits),
                    waits_per_pack=sorted(set(self.pack_waits)),
                    installs=len(self.install_waits),
                    install_waits=sum(self.install_waits),
                    prefill_rounds=len(self.prefill_extra),
                    decode_rounds=self._decode_rounds() - self.rounds0,
                    decode_fetches=sum(self.decode_counts))

    def findings(self) -> list[Finding]:
        if not self.finished:
            return [_finding("ESS107", "driver",
                             "cluster workload did not finish in 100 "
                             "steps")]
        stray = (self._waits[0] - sum(self.pack_waits)
                 - sum(self.prefill_extra) - sum(self.decode_counts)
                 - sum(self.install_waits))
        return check_migration_packs(
            self.pack_waits, self.packs_per_rid, self.prefill_extra,
            self.decode_counts, self._decode_rounds() - self.rounds0,
            stray, install_waits=tuple(self.install_waits))


def smoke_cluster(cfg=None, *, device=None, decode_session_cls=None):
    """A 1-prefill + 1-decode smoke :class:`EssCluster` (two slots each,
    random weights from seed 0) on ``device`` (the card by default);
    ``decode_session_cls`` is injectable so a test can show ESS107
    catching a decode round that smuggles a second wait."""
    from repro_torch import resolve_device
    from repro_torch.cluster import EssCluster
    from repro_torch.models.params import init_params
    cfg = cfg if cfg is not None else smoke_cfg()
    dev = resolve_device(device)
    return EssCluster(init_params(cfg, 0, device=dev), cfg, num_prefill=1,
                      num_decode=1, num_slots=2, max_seq=AUDIT_MAX_SEQ,
                      prefill_chunk=8, compiled=dev.type == "cuda",
                      device=dev, decode_session_cls=decode_session_cls)


def audit_cluster(cluster, requests=None) -> ClusterWatch:
    """Drive ``requests`` (the mixed workload by default) through
    ``cluster`` under a :class:`ClusterWatch`; returns the closed watch."""
    from repro_torch.serving.api import SamplingParams
    requests = requests if requests is not None else mixed_requests()
    with ClusterWatch(cluster) as w:
        for r in requests:
            cluster.submit(r.prompt_len, SamplingParams(
                max_tokens=r.max_new_tokens, temperature=r.temperature,
                seed=r.seed))
        guard = 100
        while cluster.has_work() and guard:
            cluster.step()
            guard -= 1
    w.finished = not cluster.has_work()
    return w


# ---------------------------------------------------------------------------
# every audit on the smoke config
# ---------------------------------------------------------------------------

def run_all(*, device=None) -> tuple[list[Finding], dict]:
    """Every driver on the smoke config: the mixed workload through a
    Q = 1 session and an MTP depth-2 pipelined one (two passes each), an
    int8 and an fp8 session (the first decode round profiled eager), and
    the PD cluster.  Returns ``(findings, counts by driver)``."""
    findings, counts = [], {}
    for name, cfg, kw, passes, prof in (
            ("q1", smoke_cfg(), {}, 2, None),
            ("mtp2+pipelined", smoke_cfg(),
             dict(mtp_depth=2, overlap=True), 2, None),
            ("int8", smoke_cfg("int8"), {}, 1, 0),
            ("fp8", smoke_cfg("fp8"), {}, 1, 0)):
        w = audit_session(smoke_session(cfg, device=device, **kw),
                          name=name, passes=passes, profile_decode=prof)
        findings += w.findings()
        counts[name] = w.counts()
    w = audit_cluster(smoke_cluster(device=device))
    findings += [dataclasses.replace(f, scope=f"cluster/{f.scope}")
                 for f in w.findings()]
    counts["cluster"] = w.counts()
    return findings, counts
