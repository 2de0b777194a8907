"""The count's parse per bank: the native FASTQ parse and 2-bit encode
on the producer thread, which overlaps the count's device work (the
self time of the program's ``count.parse`` spans), in s."""

from benchmark import spans


def read(run):
    return spans.per_step(run, ["count.parse"], within="count")
