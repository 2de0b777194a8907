"""``graph.simplify()`` per step: the program's ``simplify`` span (tips,
bulges, erroneous connections and their recompactions; ended by a
synchronise), whole, in s."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["simplify"], within="simplify", whole=True)
