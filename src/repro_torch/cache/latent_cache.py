"""ESS latent-cache state (counterpart of ``repro.cache.latent_cache``):
host tier + device pools + indexer cache.

* ``host_latent`` — the **Total Memory Pool**, a CPU tensor, **pinned**
  when the caches live on the card (the UVA kernels read and write it
  there).  Paged (default with ``offload_kv``): ``[L, NP, R, D]`` plus
  block tables ``[B, NB]``; dense: ``[L, B, max_seq, D]``.
* ``ikeys`` — per-layer ``[B, S, Di]`` Indexer-Cache tensors on the device,
  never offloaded.
* ``pools`` — per-layer :class:`repro_torch.core.lru_pool.PoolState`, the
  device-side **Sparse Memory Pool**.

The decode and prefill steps update ``host_latent``, ``ikeys`` and
``pools`` in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import lru_pool as LP


class ESSCaches(NamedTuple):
    lens: torch.Tensor                 # [B] int64
    host_latent: torch.Tensor          # dense [L,B,S,D] | paged [L,NP,R,D]
    ikeys: list                        # L x [B, S, Di]
    pools: list                        # L x PoolState
    block_tables: Optional[torch.Tensor] = None   # [B, NB] (paged only)
    host_scales: Optional[torch.Tensor] = None    # quantized tier: not ported


def pool_entries(cfg: ArchConfig, max_seq: int) -> int:
    return LP.pool_entries_for(cfg.ess.sparse_memory_ratio, max_seq,
                               cfg.dsa.index_topk, cfg.ess.pool_min_entries)


def uses_paged_host(cfg: ArchConfig) -> bool:
    """Paged host tier is the default for offloaded configs."""
    return cfg.ess.offload_kv and cfg.ess.paged_host


def num_blocks(cfg: ArchConfig, max_seq: int) -> int:
    return -(-max_seq // cfg.ess.host_page_rows)


def init_ess_caches(cfg: ArchConfig, batch: int, max_seq: int, dtype=None,
                    *, device=None) -> ESSCaches:
    """Decode caches for ``batch`` slots of up to ``max_seq`` tokens on
    ``device`` (the card by default; raises without one unless
    ``device="cpu"``).  The host tier stays on the CPU, pinned for a CUDA
    device.  Paged: ``batch * NB`` pages, slot ``b`` mapped onto pages
    ``[b*NB, (b+1)*NB)`` (the reference's ``map_slots=True`` layout for
    fixed-batch callers)."""
    dev = resolve_device(device)
    if cfg.ess.host_cache_dtype != "bf16":
        raise NotImplementedError(
            f"host_cache_dtype={cfg.ess.host_cache_dtype!r}: only the bf16 "
            f"tier is ported")
    dtype = cfg.param_dtype if dtype is None else dtype
    Lh, D, Di = cfg.num_layers, cfg.mla.latent_dim, cfg.dsa.index_dim
    P = pool_entries(cfg, max_seq)
    pin = dev.type == "cuda"

    block_tables = None
    if uses_paged_host(cfg):
        R = cfg.ess.host_page_rows
        NB = num_blocks(cfg, max_seq)
        host = torch.zeros((Lh, batch * NB, R, D), dtype=dtype,
                           pin_memory=pin)
        block_tables = torch.arange(batch * NB, dtype=torch.int64,
                                    device=dev).view(batch, NB)
    else:
        host = torch.zeros((Lh, batch, max_seq, D), dtype=dtype,
                           pin_memory=pin and cfg.ess.offload_kv)
        if not cfg.ess.offload_kv:
            host = host.to(dev)
    return ESSCaches(
        lens=torch.zeros((batch,), dtype=torch.int64, device=dev),
        host_latent=host,
        ikeys=[torch.zeros((batch, max_seq, Di), dtype=dtype, device=dev)
               for _ in range(Lh)],
        pools=[LP.init_pool(batch, P, max_seq, D, dtype, dev)
               for _ in range(Lh)],
        block_tables=block_tables)
