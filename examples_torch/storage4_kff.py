"""KFF (K-mer File Format) output + read-back (ref: dbgh5 -kff and the
kff-tools ecosystem)."""
import os
import tempfile
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.kmer.counting import count_kmers
from gatb_core_tpu_torch.storage.kff import write_kff, read_kff

from _common import device

rng = np.random.default_rng(2)
genome = "".join(rng.choice(list("ACGT"), size=1000))
res = count_kmers(BankStrings(genome, genome), kmer_size=21,
                  abundance_min=1, device=device())
_fd, path = tempfile.mkstemp(suffix=".kff")
os.close(_fd)
write_kff(path, res.solid_kmers, res.solid_counts, 21)
k, entries, _enc = read_kff(path)
print(f"KFF round-trip: {len(entries)} kmers at k={k},",
      "equal:", len(entries) == len(res.solid_kmers))
