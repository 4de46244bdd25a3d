"""95th percentile of the serve rounds from a request's submission to its
first token (ServeReport.ttft_rounds), over the requests due in the
window that got one."""

from essbench.harness import percentile

SOURCE = "program_counter"


def read(run, ctx):
    return percentile(run.ttft_rounds, 95)
