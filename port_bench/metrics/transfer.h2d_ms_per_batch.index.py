"""Host-to-device copy time per batch."""


def read(r):
    b = r.traced.get("batches")
    if r.trace is None or not b or "h2d" not in r.trace.by_group:
        return None
    return 1e3 * r.trace.by_group["h2d"] / b
