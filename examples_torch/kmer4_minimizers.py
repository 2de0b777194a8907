"""Kmer model + minimizers over a sequence (ref: examples/kmer/kmer5.cpp
minimizer iteration)."""
import numpy as np
import torch
from gatb_core_tpu_torch.ops.kmer_ops import extract_kmers, kmers_to_py
from gatb_core_tpu_torch.kmer.model import kmer_to_string

from _common import device

dev = device()
seq = "CATTGATAGTCCAGTAATGACCGTTAACGATTAGC"
codes = np.frombuffer(seq.encode(), np.uint8)
lut = np.zeros(256, np.uint8)
for i, c in enumerate("ACTG"):
    lut[ord(c)] = i
k, m = 11, 5
batch = torch.from_numpy(lut[codes][None, :]).to(dev)
kb = extract_kmers(batch, torch.ones_like(batch, dtype=torch.bool),
                   torch.tensor([len(seq)], dtype=torch.int32, device=dev),
                   k, m)
valid = kb.valid[0]
kmers = kmers_to_py(kb.kmers[0][valid])
mins = kb.minimizer[0][valid].tolist()
for v, mm in list(zip(kmers, mins))[:5]:
    print(kmer_to_string(v, k), "minimizer_hash:", hex(int(mm)))
print(f"{len(kmers)} canonical kmers")
