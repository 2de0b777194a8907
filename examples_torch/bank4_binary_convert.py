"""Binary bank conversion round-trip (ref: examples/bank/bank9.cpp,
bank24.cpp — BankBinary + converter)."""
import os
import tempfile
from gatb_core_tpu_torch.bank.binary import BankBinary, convert_bank
from gatb_core_tpu_torch.bank.fasta import BankFasta

from _common import device

device()  # host only: the flag is taken and unused

src = "/root/reference/gatb-core/test/db/reads1.fa"
fd, out = tempfile.mkstemp(suffix=".bin")
os.close(fd)
n = convert_bank(BankFasta(src), out)
back = [s.data for s in BankBinary(out)]
orig = [s.data for s in BankFasta(src)]
print(f"converted {n} sequences; round-trip equal:", back == orig)
os.unlink(out)
