"""Device milliseconds a round in matrix-product kernels (cuBLAS: the
projections, the MoE's expert products, the unembedding), from the
profiled slice."""

from essbench.trace import GEMM_NAMES, kernel_s

SOURCE = "device_trace"


def read(run, ctx):
    s = kernel_s(run.trace, GEMM_NAMES)
    return 1e3 * s / len(run.slice_work) if s > 0 and run.slice_work \
        else None
