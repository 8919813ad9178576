"""Stream syncs inside the consensus (`index:consensus`) per batch, counted
by PyTorch's sync-debug mode."""

from port_bench import program_spans


def read(r):
    return program_spans.syncs_per_batch(r, "index:consensus")
