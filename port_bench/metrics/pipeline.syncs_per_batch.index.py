"""Stream syncs inside the pipeline's calls (`index:call` and every span
under it) per batch, counted by PyTorch's sync-debug mode."""

from port_bench import program_spans


def read(r):
    return program_spans.syncs_per_batch(r, "index:call")
