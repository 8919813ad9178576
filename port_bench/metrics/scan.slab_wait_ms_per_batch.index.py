"""Host milliseconds the indexing thread waited for the next slab
(`prefetch:wait` on the thread of `index:call`) per batch."""

from port_bench import program_spans


def read(r):
    return program_spans.ms_per_batch(r, "prefetch:wait", within="index:call")
