"""Hardware profiles for the high-fidelity simulator (paper §4.1): the
port's own copy of ``repro.simulator.hardware``, the numbers unchanged.

``H800_EP32`` is the paper's calibrated H800 cluster (4 nodes x 8 H800,
EP = 32) and ``TPU_V5E`` the reference's projection onto a TPU v5e pod.
Neither describes the card the port runs on: nothing here was measured
on it, and the simulator's outputs are the paper's model, not the port's
timings.

The paper's simulator is built from real-machine metadata; ours is built
from (a) physical datasheet constants and (b) the paper's own published
measurement points (FlashTrans 37/43 GB/s, cudaMemcpyAsync 0.79/0.23 GB/s,
Table 2 throughputs) which serve as the calibration metadata.  The same
machinery parameterized with TPU v5e constants produces the projections
used alongside the dry-run roofline.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MFUCurve:
    """GEMM efficiency vs. rows (arithmetic-intensity saturation).

    eff(rows) = eff_max * rows / (rows + rows_half)  — the Michaelis-Menten
    shape reproduces Figure 1's throughput-vs-batch saturation; the two
    parameters are calibrated against Table 2 (see costmodel.calibrate)."""
    eff_max: float = 0.62
    rows_half: float = 830.0

    def __call__(self, rows: float) -> float:
        return self.eff_max * rows / (rows + self.rows_half)


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    # per accelerator
    peak_flops: float            # effective dense peak (model dtype), FLOP/s
    hbm_bw: float                # bytes/s
    hbm_bytes: float
    # scale-out fabric (per device, usable)
    fabric_bw: float             # bytes/s for EP all-to-all / allreduce
    # host link
    h2d_bw: float                # FlashTrans-grade coalesced transfers
    d2h_bw: float
    h2d_naive_bw: float          # fragmented small-block baseline
    d2h_naive_bw: float
    host_mem_bytes: float
    mfu: MFUCurve = MFUCurve()
    # misc overheads (seconds)
    kernel_launch: float = 3e-6
    a2a_latency: float = 15e-6


# Paper's system: 4 nodes x 8 H800, TP=1, EP=32, PCIe 5, FlashMLA engine.
# H800: ~989 TF bf16 (paper serves fp8 weights; effective GEMM peak taken
# as bf16 tensor-core rate which the calibration absorbs), 80 GB @ 3.35 TB/s,
# NVLink intra-node + IB inter-node (fabric ~ 25 GB/s/GPU usable for EP a2a).
H800_EP32 = HardwareProfile(
    name="h800-4node-ep32",
    peak_flops=1979e12,        # fp8 tensor-core peak (paper serves fp8)
    hbm_bw=3.35e12,
    hbm_bytes=80e9,
    fabric_bw=50e9,            # 8x400Gb IB per node / 8 GPUs, usable
    h2d_bw=37e9,            # paper §3.1 (FlashTrans)
    d2h_bw=43e9,
    h2d_naive_bw=0.79e9,    # paper §3.1 (cudaMemcpyAsync, 656 B blocks)
    d2h_naive_bw=0.23e9,
    host_mem_bytes=2e12,
    # MFU curve calibrated against 4 Table-2 anchor rows (costmodel.calibrate
    # reproduces this fit): 32K improvement +74.9 % (paper +69.4 %), 128K
    # +102.2 % (paper +123 %), all Table-2 rows within ±11 %.
    mfu=MFUCurve(eff_max=0.95, rows_half=772.85),
)

# TPU v5e chip (deployment target of this repo; roofline constants match
# the dry-run analysis): 197 TF bf16, 16 GB @ 819 GB/s, ICI 3 links x
# ~50 GB/s, PCIe gen3-class host DMA.
TPU_V5E = HardwareProfile(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    hbm_bytes=16e9,
    fabric_bw=50e9,
    h2d_bw=16e9,
    d2h_bw=16e9,
    h2d_naive_bw=0.4e9,
    d2h_naive_bw=0.2e9,
    host_mem_bytes=512e9,
    mfu=MFUCurve(eff_max=0.55, rows_half=600.0),
)

PROFILES = {"h800": H800_EP32, "v5e": TPU_V5E}
