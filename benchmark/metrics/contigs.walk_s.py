"""The Monument walk on the host per step: the self time of the
program's ``contigs.walk`` spans under ``contigs``, in s."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["contigs.walk"], within="contigs")
