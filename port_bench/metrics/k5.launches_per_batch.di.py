"""K5 calls (the program's counter ``search.k5_launches``) per indexed
batch (``index.batches``) in the profiled window's record. None where the
program has no recorder or no such counter."""


def read(r):
    if r.trace is None:
        return None
    try:
        from latice_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    if rec is None or not rec.counters.get("index.batches") or "search.k5_launches" not in rec.counters:
        return None
    return rec.counters["search.k5_launches"] / rec.counters["index.batches"]
