"""K1's share of its bound: one launch a batch over the whole dictionary,
bounded by its operations at the f32 peak, over K1's device time."""

from port_bench import yardstick


def read(r):
    b, t = r.traced.get("batches"), (r.trace.by_group.get("k1") if r.trace else None)
    if not b or not t:
        return None
    rows = r.cfg["rows_per_phase"] * len(r.cfg["phases"])
    bound = yardstick.k1_bound_s(r.traffic["batch"], rows, r.cfg["latent_dim"], r.cfg["top_n"])
    return 100.0 * b * bound / t
