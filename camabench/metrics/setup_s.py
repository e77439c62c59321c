"""Seconds from the process's start to the window's start: imports, the
card's context, fixtures, the kernels' and compositor's builds (first run
of a checkout), the program's stores filled and the warm passes."""
UNIT, SOURCE = "s", "host_clock"


def read(r):
    return r.setup_s
