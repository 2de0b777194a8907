"""Open a bank by URI and iterate its sequences (ref: examples/bank/bank1.cpp)."""
import sys
from gatb_core_tpu_torch import open_bank

from _common import device

device()  # host only: the flag is taken and unused

uri = sys.argv[1] if len(sys.argv) > 1 else \
    "/root/reference/gatb-core/test/db/reads1.fa"
bank = open_bank(uri)
n, total = 0, 0
for seq in bank:
    n += 1
    total += len(seq)
print(f"{n} sequences, {total} nt, estimate={bank.estimate()}")
