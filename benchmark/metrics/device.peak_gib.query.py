"""Peak device memory over the query cell's window, read as
``device.peak_gib.build`` reads it."""

from benchmark.harness import metric

read = metric("device.peak_gib.build").read
