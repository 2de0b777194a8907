"""The simplification's recompactions of the live graph per step (the
remapped sweep, ``build_unitigs``, ``link_unitigs``): the self time of
the program's ``simplify.compact`` spans under ``simplify``, in s."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["simplify.compact"], within="simplify")
