"""setup_s: from the first line of run.py to the window's start: imports,
the inputs, the libraries' build or load, the warm pass (host clock)."""


def read(run):
    return run.setup_s
