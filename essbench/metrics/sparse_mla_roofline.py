"""The sparse-MLA kernels' share of their roofline in the profiled slice:
the least time of every decode query's attention in every layer (the
selected rows, or every row without an indexer, read once; the query
read and the output written; the products at the bf16 peak), summed,
over the device time of the partial and merge kernels (percent)."""

from essbench.roofline import counts as K
from essbench.trace import SPARSE_MLA_NAMES, kernel_s

SOURCE = "device_trace"


def read(run, ctx):
    t = kernel_s(run.trace, SPARSE_MLA_NAMES)
    if t <= 0:
        return None
    L = ctx.conf["num_hidden_layers"]
    bound = sum(K.bound_s(*K.sparse_mla(ctx.conf, c))
                for dec, _ in run.slice_work for c in dec) * L
    return 100.0 * bound / t
