"""``graph.contigs(traversal="monument")`` per step: the program's
``contigs`` span (the compaction it reuses, the host view, the walk;
ended by a synchronise), whole, in s."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["contigs"], within="contigs", whole=True)
