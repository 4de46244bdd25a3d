"""The indexer kernels' share of their roofline in the profiled slice: the
least time of every decode query's scores in every layer (its valid keys
and the query read once, a float32 score a key written, the products at
the bf16 peak), summed, over the indexer kernels' device time (percent)."""

from essbench.roofline import counts as K
from essbench.trace import INDEXER_NAMES, kernel_s

SOURCE = "device_trace"


def read(run, ctx):
    t = kernel_s(run.trace, INDEXER_NAMES)
    if t <= 0:
        return None
    L = ctx.conf["num_hidden_layers"]
    bound = sum(K.bound_s(*K.indexer(ctx.conf, c))
                for dec, _ in run.slice_work for c in dec) * L
    return 100.0 * bound / t
