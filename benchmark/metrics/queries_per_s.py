"""k-mers answered (each once, though both calls answer it) over the
window's time, in Mkmer/s: the step's work over the window, read as
``bases_per_s`` reads it."""

from benchmark.harness import metric

read = metric("bases_per_s").read
