"""Seconds from the start of the process to the start of the window."""


def read(r):
    return r.setup_s
