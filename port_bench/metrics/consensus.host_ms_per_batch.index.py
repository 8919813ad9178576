"""Host milliseconds inside the consensus (`index:consensus`) per batch."""

from port_bench import program_spans


def read(r):
    return program_spans.ms_per_batch(r, "index:consensus")
