"""Patterns whose results reached the host inside the window, per second
of the window."""


def read(r):
    n = r.work.get("patterns")
    return None if n is None else n / r.window_s
