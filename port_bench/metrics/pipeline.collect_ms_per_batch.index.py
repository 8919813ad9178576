"""Host milliseconds of the copy of the results back (`index:collect`) per
batch."""

from port_bench import program_spans


def read(r):
    return program_spans.ms_per_batch(r, "index:collect")
