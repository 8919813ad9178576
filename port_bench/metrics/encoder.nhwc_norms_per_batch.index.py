"""K2f launches on channels_last tensors (the program's counter
``encoder.nhwc_norms``) per indexed batch (``index.batches``) in the
profiled window's record. None where the program has no recorder or no
such counter."""


def read(r):
    if r.trace is None:
        return None
    try:
        from latice_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    if (rec is None or not rec.counters.get("index.batches")
            or "encoder.nhwc_norms" not in rec.counters):
        return None
    return rec.counters["encoder.nhwc_norms"] / rec.counters["index.batches"]
