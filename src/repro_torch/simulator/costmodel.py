"""The PD handoff's link model (the port's own copy of
``InterNodeModel`` from ``repro.simulator.costmodel`` and the constants it
reads; the rest of the reference's analytic cost model is not ported).

Byte counts use the paper's fp8 serving layout of DeepSeek-V3.2-Exp: a
latent entry is 656 B (576 dims + scales), an indexer entry 132 B (about
16.8 % of the cache bytes), over 61 layers.
"""

from __future__ import annotations

import dataclasses

N_LAYERS = 61
LATENT_BYTES = 656          # paper section 2.2
IDX_BYTES = 132             # 16.8 % of (656 + 132)


@dataclasses.dataclass(frozen=True)
class InterNodeModel:
    """Prefill -> decode migration link (the PD handoff's wire).

    One migration moves a prompt's latent state at page granularity, per
    layer the prompt's latent rows in the host tier's storage dtype plus
    its indexer-key rows, as one packet: ``t = latency + bytes /
    bandwidth``, the latency paid once per handoff."""
    bandwidth: float         # bytes/s, usable point-to-point fabric
    latency_s: float         # per packet
    row_bytes: int = LATENT_BYTES

    def packet_bytes(self, rows: float, num_layers: int = N_LAYERS
                     ) -> float:
        """Wire bytes of one migration: latent payload (+ per-row scales,
        folded into ``row_bytes``) and indexer keys across the stack."""
        return num_layers * rows * (self.row_bytes + IDX_BYTES)

    def transfer_time(self, rows: float, num_layers: int = N_LAYERS
                      ) -> float:
        return self.latency_s + self.packet_bytes(rows, num_layers) \
            / self.bandwidth
