"""Reproduce the paper's headline numbers with the high-fidelity simulator:
the port's mirror of ``examples/simulate_paper.py``, on the port's numpy
copy of the simulator (no device, no JAX), printing the same lines.

The numbers are the paper's H800 model (``H800_EP32``), not a measurement
of any card the port runs on.

Prints Table 2 (all 18 rows, simulated vs published), the two abstract
claims (+69.4 % @32K, +123 % @128K), and the figure-level behaviours
(warmup, overlap crossover, miss scaling).

    PYTHONPATH=src python examples/simulate_paper_torch.py
"""

import sys

sys.path.insert(0, "src")

from repro_torch.simulator import experiments as E


def main() -> None:
    print("=== Table 2: throughput & OTPS (sim vs paper) ===")
    print(f"{'mtp':>3} {'acc':>4} {'ctx':>6} {'BS':>4} {'ratio':>5} "
          f"{'sim thr':>9} {'paper':>9} {'dev':>6}")
    for r in E.table2():
        print(f"{r['mtp']:>3} {r['accept']:>4} {r['context']:>6} "
              f"{r['batch']:>4} {r['ratio']:>5} "
              f"{r['sim_throughput']:>9.0f} {r['paper_throughput']:>9.0f} "
              f"{r['dev_pct']:>5.1f}%")

    h = E.headline_improvements()
    print(f"\n32K improvement: +{h['improvement_32k_pct']:.1f}% "
          f"(paper +{h['paper_32k_pct']})")
    print(f"128K improvement: +{h['improvement_128k_pct']:.1f}% "
          f"(paper +{h['paper_128k_pct']})")

    print("\n=== Fig 4: LRU-Warmup ===")
    w = E.fig4_warmup(steps=16)
    print(" cold:", w["before_warmup"][:8])
    print(" warm:", w["after_warmup"][:8])

    print("\n=== Fig 7: overlap strategies (per-layer ms vs miss count) ===")
    for r in E.fig7_overlap_comparison():
        print(f" miss={r['miss']:>5}: none={r['none_ms']:.3f} "
              f"da={r['da_ms']:.3f} dba={r['dba_ms']:.3f}")

    print("\n=== §2.1 memory wall ===")
    print(" ", E.memory_analysis())
    print("\n=== §3.1 FlashTrans ===")
    print(" ", E.flashtrans_comparison())


if __name__ == "__main__":
    main()
