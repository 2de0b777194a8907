"""The device's idle share in the query cell, read as
``device.idle_pct.build`` reads it."""

from benchmark.harness import metric

read = metric("device.idle_pct.build").read
