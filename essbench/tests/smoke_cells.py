"""Throwaway cells at the port's smoke widths, for CPU runs of the harness.

:func:`write` puts two configuration files, one workload file per traffic
kind and nothing else into a folder of its own; :func:`bench` is the
``BENCHMARK.json`` that names them, with the real file's metrics.  A test
hands both to ``essbench.spec.Specs``: the harness finds them by name, as
it finds the benchmark's own cells.
"""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SMOKE_V3 = {
    "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
    "intermediate_size": 128, "vocab_size": 256, "num_hidden_layers": 2,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
    "num_nextn_predict_layers": 0, "q_lora_rank": 48, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "moe_intermediate_size": 64, "n_routed_experts": 4,
    "num_experts_per_tok": 2, "n_shared_experts": 1,
    "first_k_dense_replace": 1, "routed_scaling_factor": 1.0,
    "norm_topk_prob": True, "reference": "deepseek",
    "port": {"arch": "deepseek-v3-671b-smoke", "moe_capacity_factor": 2.0},
}
SMOKE_V32 = {
    **SMOKE_V3, "index_n_heads": 2, "index_head_dim": 16, "index_topk": 8,
    "port": {"arch": "deepseek-v32-exp-ess-smoke",
             "moe_capacity_factor": 2.0, "ess": {"max_miss_ratio": 1.0}},
}

CELLS = {
    "t-pd": {"config": "smoke-v32", "traffic": "pd_closed_loop",
             "params": {"contexts": 2, "prompt_len": [24, 40],
                        "concurrency": 4, "new_tokens": [4, 12],
                        "temperature": 1.0, "greedy_every": 2,
                        "prefill_slots": 2, "prefill_chunk": 16,
                        "max_seq": 56, "requests": 4096, "warm_rounds": 2,
                        "slice_after": 2, "slice_rounds": 3, "sample": 8}},
    "t-v3": {"config": "smoke-v3", "traffic": "fixed_batch_replay",
             "params": {"batch": 4, "prompt_len": 24, "new_tokens": 6,
                        "prefill_group": 2, "slice_after": 1,
                        "slice_rounds": 3, "sample": 8}},
    "t-chat": {"config": "smoke-v32", "traffic": "open_loop_chat",
               "params": {"slots": 4, "max_seq": 80, "prefill_chunk": 16,
                          "rate": 20.0, "prompt_len": [8, 48],
                          "new_tokens": [2, 8], "slice_after": 2,
                          "slice_rounds": 3, "sample": 8}},
}
# a limit the sound smoke runs keep and the planted faults pass
LIMIT = 1e-3


def write(root: Path, dtype: str = "float32") -> Path:
    for name, conf in (("smoke-v3", SMOKE_V3), ("smoke-v32", SMOKE_V32)):
        c = {"name": name, **conf,
             "port": {**conf["port"], "param_dtype": dtype}}
        (root / "configs").mkdir(parents=True, exist_ok=True)
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
    (root / "workloads").mkdir(exist_ok=True)
    for name, w in CELLS.items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            {"name": name, "chips": 1, "why": "a CPU run of the harness",
             "check": {"logit_gap_max": LIMIT}, **w}))
    return root


def bench() -> dict:
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    alias = {"v32-pd-decode-32k": "t-pd", "v3-dense-decode-8k": "t-v3",
             "v32-chat-2k": "t-chat"}

    def rename(m):
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = [alias[w] for w in m["workloads"]]
        return m
    return {**real,
            "workloads": [{"name": n, "config": w["config"],
                           "traffic": w["traffic"], "chips": 1, "why": "cpu"}
                          for n, w in CELLS.items()],
            "end_to_end": [rename(m) for m in real["end_to_end"]],
            "per_layer": [rename(m) for m in real["per_layer"]]}
