"""PD-disaggregated serving on the port: one prefill worker, two decode
workers — the mirror of ``examples/serve_cluster.py`` (the same smoke
config, slots, ``max_seq``, prompts and sampling knobs, and the channel
built from the port's ``internode_model(H800_EP32)``, the paper's
calibrated H800 fabric; random weights from a torch seed).  On one card
the workers share the weights.

The paper's Figure 3 separates prefill and decode into distinct node
pools joined by a "Load" arrow — a prompt prefills on a bandwidth-rich
worker, then its latent state migrates (page-granular, storage dtype on
the wire) to a decode worker that owns the rest of its lifetime.  This
example drives that topology through ``EssCluster``, the multi-node
drop-in for ``EssEngine``, and shows:

* **bitwise parity** — the clustered streams match a single engine's
  exactly, including a seeded sampling request (the packet carries
  pages, scale planes, indexer keys, first token and MTP hidden, so the
  decode worker reproduces the single-node math bit for bit);
* **the handoff itself** — migration packets crossing a simulated
  inter-node channel with a cost-model-derived delay, and the byte
  accounting of what travelled;
* **slot recycling** — the prefill worker's slots free at pack time,
  not at request completion: prefill capacity is never held hostage by
  decode lifetimes;
* **routing** — the router placing each migration on the decode worker
  with the most free host bytes, so load spreads without rejections.

    PYTHONPATH=src python examples/serve_cluster_torch.py               # card
    PYTHONPATH=src python examples/serve_cluster_torch.py --device cpu  # CPU

Without a CUDA device it stops unless given ``--device cpu``.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.cluster import EssCluster, InterNodeChannel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.serving.api import EssEngine, SamplingParams  # noqa: E402
from repro_torch.simulator.costmodel import internode_model  # noqa: E402
from repro_torch.simulator.hardware import H800_EP32  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the eager rounds on the CPU (default: "
                         "the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("deepseek-v32-exp-ess-smoke")
    params = init_params(cfg, 0, device=dev)
    kw = dict(compiled=dev.type == "cuda", device=dev)
    SMAX = 64
    prompts = [14, 10, 12, 9, 11]
    sp = [SamplingParams(max_tokens=6),
          SamplingParams(max_tokens=5),
          SamplingParams(max_tokens=4, temperature=0.9, seed=7),
          SamplingParams(max_tokens=5),
          SamplingParams(max_tokens=6)]

    print("-- single-engine reference --")
    eng = EssEngine(params, cfg, num_slots=2, max_seq=SMAX, **kw)
    ref = eng.generate(prompts, sp, max_rounds=300)
    for o in ref:
        print(f"  rid{o.rid}: {o.tokens} ({o.finish_reason})")

    print("\n-- 1 prefill + 2 decode workers, cost-model channel --")
    # the channel's delay comes from the calibrated H800 fabric model:
    # latency + wire_bytes / bandwidth, quantized to serve steps
    channel = InterNodeChannel(model=internode_model(H800_EP32),
                               step_time_s=5e-3)
    clu = EssCluster(params, cfg, num_prefill=1, num_decode=2,
                     num_slots=2, max_seq=SMAX, channel=channel, **kw)
    outs = clu.generate(prompts, sp, max_rounds=300)
    for o in outs:
        print(f"  rid{o.rid}: {o.tokens} ({o.finish_reason})")

    assert [(o.tokens, o.finish_reason) for o in outs] \
        == [(o.tokens, o.finish_reason) for o in ref], \
        "clustered streams must match the single engine bitwise"
    print("\nstreams bitwise identical across the PD handoff "
          "(incl. the seeded sampling request)")

    m = clu.metrics()
    print(f"\nmigrations: {m['migrations']} packed, {m['installed']} "
          f"installed; wire: {m['wire_bytes']} B, "
          f"{m['sim_transfer_s']*1e3:.2f} ms simulated transfer")
    print(f"decode tokens per worker: "
          f"{[w.session.report.decode_tokens for w in clu.decode]} "
          f"(router spread by free host bytes)")
    pre = clu.prefill[0].session
    print(f"prefill worker: {pre.report.prefill_chunks} chunks, "
          f"{pre.report.prefill_tokens} prompt tokens, all "
          f"{pre.allocator.free_pages}/{pre.allocator.num_pages} host "
          f"pages free again — slots recycled at pack time")
    assert m["migrations"] == len(prompts) == m["installed"]
    assert m["rejected"] == 0
    print("\nok")


if __name__ == "__main__":
    main()
