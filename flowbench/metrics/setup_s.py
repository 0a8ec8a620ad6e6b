"""``setup_s``: from the process's start to the window's first pair: the
kernel library's load (or build), the traffic made, the graphs captured
and warmed up."""


def read(run):
    return run.setup_s
