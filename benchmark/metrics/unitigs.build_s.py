"""``graph.unitig_graph()`` per bank: the program's ``unitigs.build``
span (ended by a synchronise), whole, in s. The in-program twin of
``dbg.unitigs_s``."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["unitigs.build"], within="unitigs.build",
                          whole=True)
