"""setup_s: seconds from the process's start to the window's start
(the capture written, the program's first use, the cell's shapes
warmed)."""


def read(run):
    return run.setup_s
