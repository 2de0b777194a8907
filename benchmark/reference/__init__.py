"""Plain reference of the benchmark's cells: torch and numpy only.

It imports nothing of ``gatb_core_tpu_torch`` (or of the JAX package): it
works the count, the graph and the node queries out again from the same
generated reads, and reads the program's outputs only to judge them.
"""
