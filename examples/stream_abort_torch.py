"""Request-lifecycle front-end of the port: interleaved streaming
clients, a mid-generation abort, a stop-sequence early exit, and
priority-aware admission — the `EssEngine` API surface that makes the
paper's decoupled batch-size scaling usable by real workloads.  The
mirror of ``examples/stream_abort.py``: the same smoke config, slots,
``max_seq``, prompt lengths and request knobs; the prompts drawn with
numpy and the weights with torch, so the streams are the port's own.

Four clients share two decode slots of one ESS serve loop:

* **rid0 (streamer)** — consumed incrementally through the
  ``stream(rid)`` generator, token event by token event, until its
  ``finish_reason="length"`` terminal record;
* **rid1 (abort)** — a long request a client disconnects from after
  three tokens: ``abort(rid)`` returns its host pages to the allocator
  *immediately* (between two serve rounds), fully resets the slot, and
  closes the stream with ``finish_reason="abort"``;
* **rid2 (stop)** — carries ``stop_token_ids`` chosen from a probe run
  of the same prompt, so its stream ends early, exactly at the stop
  position, with ``finish_reason="stop"``;
* **rid3 (priority)** — a latecomer submitted mid-run (at the moment of
  the abort, with rid2 already waiting) but with ``priority=1``: when
  the abort frees a slot, it is admitted ahead of rid2 (queued long
  before it at priority 0) — stable FIFO holds within a class, higher
  classes go first.

    PYTHONPATH=src python examples/stream_abort_torch.py               # card
    PYTHONPATH=src python examples/stream_abort_torch.py --device cpu  # CPU

Without a CUDA device it stops unless given ``--device cpu``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.api import EssEngine, SamplingParams  # noqa: E402


def prompt(seed: int, n: int, vocab: int) -> list[int]:
    return [int(t) for t in
            np.random.default_rng(seed).integers(0, vocab, n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the eager rounds on the CPU (default: "
                         "the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("deepseek-v32-exp-ess-smoke")
    params = init_params(cfg, 0, device=dev)
    NUM_SLOTS, SMAX = 2, 64
    kw = dict(compiled=dev.type == "cuda", device=dev)

    # explicit token prompts (not rid-derived), so the probe run and the
    # interleaved run below produce identical streams per prompt
    prompt_stream = prompt(11, 12, cfg.vocab_size)
    prompt_abort = prompt(12, 12, cfg.vocab_size)
    prompt_stop = prompt(13, 16, cfg.vocab_size)
    prompt_prio = prompt(14, 10, cfg.vocab_size)

    # probe: what would the stop client emit unconstrained?  Pick a
    # mid-stream token that does not occur earlier as its stop sequence.
    probe = EssEngine(params, cfg, num_slots=NUM_SLOTS, max_seq=SMAX, **kw)
    [ref] = probe.generate([prompt_stop], SamplingParams(max_tokens=10))
    stop_idx, stop_tok = next(
        (i, t) for i, t in enumerate(ref.tokens)
        if i >= 2 and t not in ref.tokens[:i])
    print(f"probe stream {ref.tokens} -> stop token {stop_tok} "
          f"(position {stop_idx})")

    engine = EssEngine(params, cfg, num_slots=NUM_SLOTS, max_seq=SMAX, **kw)
    free0 = engine.session.allocator.free_pages
    r_stream = engine.submit(prompt_stream, SamplingParams(max_tokens=8))
    r_abort = engine.submit(prompt_abort, SamplingParams(max_tokens=32))
    r_stop = engine.submit(prompt_stop, SamplingParams(
        max_tokens=10, stop_token_ids=(stop_tok,)))

    # client 1: consume rid0 incrementally; disconnect rid1 after 3
    # tokens and, at that same moment, submit a priority-1 latecomer —
    # it will take the freed slot ahead of rid2, which queued first
    aborted = False
    r_prio = None
    print(f"\nstreaming rid{r_stream}:")
    for ev in engine.stream(r_stream):
        if ev.token is not None:
            print(f"  rid{ev.rid} token[{ev.index}] = {ev.token}")
        else:
            print(f"  rid{ev.rid} terminal: {ev.finish_reason}")
        if not aborted and \
                len(engine.session.outputs.get(r_abort, [])) >= 3:
            print(f"  -> client disconnect: abort(rid{r_abort})")
            assert engine.abort(r_abort)
            r_prio = engine.submit(prompt_prio,
                                   SamplingParams(max_tokens=4, priority=1))
            print(f"  -> late submit rid{r_prio} at priority 1 "
                  f"(rid{r_stop} has been waiting at priority 0)")
            aborted = True

    # drain the remaining clients (stop + priority requests)
    while engine.has_work():
        engine.step()
    outs = {r: engine.output(r)
            for r in (r_stream, r_abort, r_stop, r_prio)}

    print("\nfinal outputs:")
    for r, o in sorted(outs.items()):
        print(f"  rid{r}: {o.finish_reason:8s} {o.tokens}")
    m = engine.metrics()
    print(f"metrics: aborted={m['aborted']} "
          f"finish_reasons={m['finish_reasons']} "
          f"ttft_p50={m['ttft_p50_s']:.3f}s itl_p50={m['itl_p50_s']:.4f}s")

    assert outs[r_stream].finish_reason == "length" \
        and outs[r_stream].n_generated == 8
    assert outs[r_abort].finish_reason == "abort" and aborted
    assert 3 <= outs[r_abort].n_generated < 32     # cut mid-generation
    # stop stream == unconstrained probe cut exactly at the stop position
    assert outs[r_stop].finish_reason == "stop"
    assert outs[r_stop].tokens == ref.tokens[:stop_idx + 1]
    # the priority-1 latecomer was admitted before the priority-0 rid2
    assert engine.session.report.ttft_rounds[r_prio] \
        < engine.session.report.ttft_rounds[r_stop]
    # the abort reclaimed its host pages immediately; all pages free now
    assert engine.session.allocator.free_pages == free0
    print("\nlifecycle OK: stream / abort / stop / priority all verified")


if __name__ == "__main__":
    main()
