"""Set-up: from the start of ``run.py`` to the window's start (loading,
making and writing the bank, building what the cell holds, the warm-up,
and in a checkout's first run the kernels' build)."""


def read(run):
    return run.setup_s
