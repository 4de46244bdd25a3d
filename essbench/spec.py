"""Finding the benchmark's pieces by name.

Everything a cell needs is a file named after it, looked up in each root
in turn (the benchmark's own folder last, so a test can bring a
throwaway piece in a folder of its own):

* ``configs/<config>.json``   the configuration as it is run (published
  keys, ``port``: how the port's ``ArchConfig`` is built from it);
* ``workloads/<cell>.json``   the cell: config, traffic kind and its
  parameters, chips, the fixed rate, the limit of its check;
* ``traffic/<kind>.py``       the generator and driver of a traffic kind;
* ``metrics/<metric>.py``     one metric: ``SOURCE`` and ``read(run)``; a
  dotted name falls back to its stem (``mfu.pd`` is read by ``mfu.py``
  unless ``mfu.pd.py`` exists), so one reader serves every cell's copy;
* ``reference/<name>.py``     the plain reference a configuration names
  under ``reference``: ``served_gaps(weights, conf, prompt, served)``;

and ``BENCHMARK.json`` says which metrics a cell reports.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

# published key -> the port's ArchConfig attribute (dotted: a sub-config)
PORT_KEYS = {
    "hidden_size": "d_model", "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads", "intermediate_size": "d_ff",
    "vocab_size": "vocab_size", "num_hidden_layers": "num_layers",
    "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta",
    "num_nextn_predict_layers": "mtp_depth",
    "q_lora_rank": "mla.q_lora_rank", "kv_lora_rank": "mla.kv_lora_rank",
    "qk_nope_head_dim": "mla.qk_nope_head_dim",
    "qk_rope_head_dim": "mla.qk_rope_head_dim",
    "v_head_dim": "mla.v_head_dim",
    "moe_intermediate_size": "moe.d_expert",
    "n_routed_experts": "moe.num_experts",
    "num_experts_per_tok": "moe.top_k", "n_shared_experts": "moe.num_shared",
    "first_k_dense_replace": "moe.first_dense_layers",
    "routed_scaling_factor": "moe.routed_scale",
    "norm_topk_prob": "moe.norm_topk",
    "index_n_heads": "dsa.index_heads", "index_head_dim": "dsa.index_dim",
    "index_topk": "dsa.index_topk",
}


class Specs:
    def __init__(self, bench: dict | None = None, roots=()):
        self.roots = [Path(r) for r in roots] + [HERE]
        self.bench = bench if bench is not None else json.loads(
            (REPO / "BENCHMARK.json").read_text())

    def find(self, kind: str, name: str, ext: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{ext}"
            if p.exists():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{ext} under "
                                f"{[str(r) for r in self.roots]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.find(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        stem = name
        while True:
            try:
                path = self.find(kind, stem, ".py")
                break
            except FileNotFoundError:
                if "." not in stem:
                    raise
                stem = stem.rsplit(".", 1)[0]
        spec = importlib.util.spec_from_file_location(
            f"essbench_{kind}_{stem.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics (``trace`` off) or per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or cell in m["workloads"]]


def arch_config(c: dict):
    """The port's ``ArchConfig`` for configuration file ``c``: the named
    registered config, cut to ``num_hidden_layers`` (MTP kept only where
    ``num_nextn_predict_layers`` is), the ``port`` overrides applied, then
    every published key that the port carries checked against it."""
    from repro_torch.configs import cut_depth, get_config
    import torch

    port = c["port"]
    cfg = get_config(port["arch"])
    cfg = cut_depth(cfg, c["num_hidden_layers"],
                    keep_mtp=c.get("num_nextn_predict_layers", 0) > 0)
    if "moe_capacity_factor" in port:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(port["moe_capacity_factor"])))
    if "ess" in port:
        cfg = dataclasses.replace(cfg, ess=dataclasses.replace(
            cfg.ess, **port["ess"]))
    if "param_dtype" in port:
        cfg = dataclasses.replace(
            cfg, param_dtype=getattr(torch, port["param_dtype"]))
    for key, attr in PORT_KEYS.items():
        if key not in c:
            continue
        obj = cfg
        for part in attr.split("."):
            obj = None if obj is None else getattr(obj, part)
        if obj is None or float(obj) != float(c[key]):
            raise ValueError(f"{c.get('name')}: {key} = {c[key]} but the "
                             f"port's {port['arch']} runs {attr} = {obj}")
    return cfg
