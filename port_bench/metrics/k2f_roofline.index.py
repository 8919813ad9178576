"""K2f's share of its bound: the summed byte bound of the encoder's
launches per batch, times the batches, over K2f's device time."""

from port_bench import yardstick


def read(r):
    b, t = r.traced.get("batches"), (r.trace.by_group.get("k2f") if r.trace else None)
    if not b or not t:
        return None
    return 100.0 * b * yardstick.norm_bound_s(r.cfg, r.traffic["batch"], False, False) / t
