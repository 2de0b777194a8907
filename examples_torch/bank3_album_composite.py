"""Album + composite banks and bank estimation
(ref: examples/bank/bank17-22.cpp family — BankAlbum/BankComposite)."""
import os
import tempfile
from gatb_core_tpu_torch.bank.fasta import BankAlbum, BankComposite, BankFasta

from _common import device

device()  # host only: the flag is taken and unused

db = "/root/reference/gatb-core/test/db"
fd, album = tempfile.mkstemp(suffix=".txt")
with os.fdopen(fd, "w") as f:
    f.write(f"{db}/reads1.fa\n{db}/reads2.fa\n")
bank = BankAlbum(album)
n, total, mx = bank.estimate()
print(f"album: ~{n} sequences, ~{total} nt, max ~{mx}")
comp = BankComposite([BankFasta(f"{db}/reads1.fa"),
                      BankFasta(f"{db}/reads2.fa")])
print("composite sequences:", sum(1 for _ in comp))
os.unlink(album)
