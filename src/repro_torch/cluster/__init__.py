"""PD-disaggregated serving cluster (counterpart of ``repro.cluster``).

:class:`EssCluster` is the multi-worker drop-in for
:class:`repro_torch.serving.api.EssEngine`; :mod:`kv_transfer` is the
page-granular latent handoff; :mod:`workers` and :mod:`router` are the
prefill / decode halves and the placement policy.
"""

from repro_torch.cluster.cluster import EssCluster
from repro_torch.cluster.kv_transfer import (InterNodeChannel, MigrationPacket,
                                             can_accept, install_migration,
                                             pack_migration)
from repro_torch.cluster.router import Router
from repro_torch.cluster.workers import DecodeWorker, PrefillWorker

__all__ = [
    "EssCluster", "InterNodeChannel", "MigrationPacket", "Router",
    "PrefillWorker", "DecodeWorker", "pack_migration", "install_migration",
    "can_accept",
]
