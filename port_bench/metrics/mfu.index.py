"""The indexing step's share of the dense bf16 peak: the encoder's model
FLOPs of the patterns completed in the profiled window, over that window."""

from port_bench import yardstick


def read(r):
    n = r.traced.get("patterns")
    if r.trace is None or not n:
        return None
    return 100.0 * n * yardstick.encoder_flops(r.cfg) / (r.trace.window_s * yardstick.PEAK_BF16)
