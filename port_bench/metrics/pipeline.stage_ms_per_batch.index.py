"""Host milliseconds of each batch's padding, pinning and H2D enqueue
(`index:stage`) per batch."""

from port_bench import program_spans


def read(r):
    return program_spans.ms_per_batch(r, "index:stage")
