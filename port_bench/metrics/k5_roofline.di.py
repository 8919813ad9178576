"""K5's share of its bound: one call a batch over the whole table, bounded
by its bytes or its operations (`yardstick_ncc.k5_bound_s`), times the
traced batches, over the device time of K5's kernels (named
``k5_cosine_topk_*``). None where no such kernel ran."""

from port_bench import yardstick_ncc


def read(r):
    b = r.traced.get("batches")
    if r.trace is None or not b:
        return None
    t = sum(s for name, s in r.trace.by_name.items() if "k5_cosine_topk" in name)
    if not t:
        return None
    bound = yardstick_ncc.k5_bound_s(r.traffic["batch"], yardstick_ncc.rows(r.cfg),
                                     yardstick_ncc.feature_dim(r.cfg), r.cfg["top_n"])
    return 100.0 * b * bound / t
