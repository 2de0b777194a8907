"""Device time per batch over the traced window, read as
``dbg.device_ms`` reads it per bank."""

from benchmark.harness import metric

read = metric("dbg.device_ms").read
