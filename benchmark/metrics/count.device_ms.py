"""Device time per bank of the count cell over the traced window, read as
``dbg.device_ms`` reads it."""

from benchmark.harness import metric

read = metric("dbg.device_ms").read
