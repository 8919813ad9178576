"""Encoder blocks run without their convolution's bias (the program's
counter ``encoder.bias_free_convs``) per indexed batch (``index.batches``)
in the profiled window's record. None where the program has no recorder or
no such counter."""


def read(r):
    if r.trace is None:
        return None
    try:
        from latice_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    if rec is None or not rec.counters.get("index.batches") or "encoder.bias_free_convs" not in rec.counters:
        return None
    return rec.counters["encoder.bias_free_convs"] / rec.counters["index.batches"]
