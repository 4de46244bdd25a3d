"""ESS serving through the port's public `EssEngine` API with continuous
batching over the paged host latent-cache: the mirror of
``examples/serve_ess.py`` (the same smoke config, slots, ``max_seq``,
page budget and requests; random weights from a torch seed, so the
streams are the port's own).

Drives ``repro_torch.serving.api.EssEngine`` — the request-lifecycle
front-end over the re-entrant serve-round core: more requests than
decode slots stream through one long-lived decode batch; admission is
gated on free host pages (the pool is provisioned *below* the dense
layout's ``slots x blocks`` pin, so the gate actually engages); a mid-run
preemption demonstrates the recovery path — pages return to the
allocator and the slot gets a full cache reset before its next
occupant, while the preempted request replays its identical stream.

Prefill is **chunked and decode-interleaved**: each serve round runs one
``prefill_chunk``-token chunk for at most one admitting slot, scattered
straight into its mapped host pages, while every running slot keeps
decoding — watch rid=4's long prompt stream in between other requests'
token events.

Decode runs **MTP speculative rounds** (depth 2) composed with
**Two-Batch Overlap**: every round drafts 2 tokens per slot, verifies all
drafts with one Q=3 step split into two overlapped half-batches, and
emits 1–3 accepted tokens per slot; rid=3 samples (temperature 0.8) via
``SamplingParams`` and transparently degrades to exact Q=1 emission
inside the same rounds.

On the card every round replays as a **CUDA graph** over the
device-resident engine state (one graph per round variant); on the CPU
(``--device cpu``) the same rounds run eagerly, and the emitted streams
are identical either way.  (See ``examples/stream_abort_torch.py`` for
the incremental ``stream()`` / ``abort()`` / stop-token side of the
API.)

With ``overlap=True`` the rounds run as the **plan/compute/commit
pipeline**: each round's indexer scores drive a speculative H2D stage
into a double-buffered slab, so most of the next round's misses arrive
pre-staged (watch the prefetch hit/miss/wasted counters in the report
line) while the residual misses fall back to the synchronous gather —
the emitted streams are bitwise identical to the synchronous path.

    PYTHONPATH=src python examples/serve_ess_torch.py               # card
    PYTHONPATH=src python examples/serve_ess_torch.py --device cpu  # CPU

Without a CUDA device it stops unless given ``--device cpu``.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.cache import latent_cache as LC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.api import EssEngine, SamplingParams  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the eager rounds on the CPU (default: "
                         "the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("deepseek-v32-exp-ess-smoke")
    cfg = dataclasses.replace(cfg, mtp_depth=2)    # 2 stacked draft modules
    params = init_params(cfg, 0, device=dev)
    NUM_SLOTS, SMAX = 2, 96

    # >= 2x num_slots requests stream through the two decode slots; the
    # later, longer requests pin 3 pages each so a freed slot has to *wait*
    # for pages — the admission gate in action.  rid=4's long prompt
    # streams through several prefill chunks while the others decode.
    workload = [(24, SamplingParams(max_tokens=6)),
                (24, SamplingParams(max_tokens=6)),
                (40, SamplingParams(max_tokens=8)),
                (40, SamplingParams(max_tokens=8, temperature=0.8,
                                    top_k=64, seed=7)),
                (72, SamplingParams(max_tokens=8))]

    # page budget far below the dense pin (2 slots x 6 blocks = 12 pages
    # would be capacity parity at page_rows=16)
    num_pages = 7
    per_req = [LC.pages_for_len(cfg, plen + sp.max_tokens)
               for plen, sp in workload]
    print(f"slots={NUM_SLOTS} pages={num_pages} (per request: {per_req}, "
          f"page_rows={cfg.ess.host_page_rows})")

    engine = EssEngine(params, cfg, num_slots=NUM_SLOTS, max_seq=SMAX,
                       num_host_pages=num_pages, prefill_chunk=16,
                       mtp_depth=2, tbo=True, overlap=True,
                       compiled=dev.type == "cuda", device=dev)
    rids = [engine.submit(plen, sp) for plen, sp in workload]

    # drive serve rounds by hand (generate() would do the same loop);
    # at round 2 preempt slot 1 — a simulated node loss on the session
    # underneath the API.  The victim requeues ahead of its priority
    # class and replays its stream on re-admission.
    rnd = 0
    while engine.has_work():
        engine.step()
        if rnd == 2 and engine.session.sched.slots[1].active:
            print("  round 2: PREEMPTING slot 1 (simulated node loss)")
            engine.session.preempt(1)
        rnd += 1
        assert rnd < 300, "serve loop failed to converge"
    outs = [engine.output(r) for r in rids]

    report = engine.session.report
    for ev in report.events:
        print(f"  {ev}")
    print(f"\nall requests served in {report.rounds} decode rounds "
          f"({report.spec_rounds} speculative); finish reasons: "
          f"{[o.finish_reason for o in outs]}")
    print(f"decode tokens: {report.decode_tokens} "
          f"({report.tokens_per_s:.1f} accepted-tok/s, "
          f"{report.rounds_per_s:.1f} rounds/s); "
          f"accept rate {report.accept_rate:.2f} "
          f"({report.accepted_tokens}/{report.drafted_tokens} drafts); "
          f"prefill: {report.prefill_tokens} toks in "
          f"{report.prefill_chunks} chunks; "
          f"admissions blocked on pages: "
          f"{engine.session.sched.blocked_admissions}; "
          f"peak pages in use: {report.peak_pages_in_use}/{report.num_pages}")
    print(f"async-offload pipeline: prefetch hits/misses/wasted rows "
          f"{report.prefetch_hits}/{report.prefetch_misses}/"
          f"{report.prefetch_wasted_rows} "
          f"(hit rate {report.prefetch_hit_rate:.2f})")
    print("ttft (serve rounds from submit to first token): "
          + ", ".join(f"rid{r}={t}" for r, t in
                      sorted(report.ttft_rounds.items())))
    for o in outs:
        print(f"  rid{o.rid} tokens: {o.tokens}")
    assert all(o.finish_reason == "length" for o in outs)
    assert engine.session.sched.blocked_admissions > 0, \
        "page gate never engaged"
    assert report.prefill_chunks > len(workload), "chunking never engaged"
    assert report.spec_rounds > 0, "speculative rounds never engaged"
    assert all(o.n_generated == sp.max_tokens
               for o, (_, sp) in zip(outs, workload))


if __name__ == "__main__":
    main()
