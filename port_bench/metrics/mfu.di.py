"""The DI search's share of the dense bf16 peak: its model FLOPs (2·N·D a
pattern) of the patterns completed in the profiled window, over that
window."""

from port_bench import yardstick_ncc
from port_bench.yardstick import PEAK_BF16


def read(r):
    n = r.traced.get("patterns")
    if r.trace is None or not n:
        return None
    return 100.0 * n * yardstick_ncc.search_flops(r.cfg) / (r.trace.window_s * PEAK_BF16)
