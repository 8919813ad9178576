"""cuDNN convolution and layout-transform device time per batch."""


def read(r):
    b = r.traced.get("batches")
    if r.trace is None or not b:
        return None
    return 1e3 * r.trace.by_group.get("convolution", 0.0) / b
