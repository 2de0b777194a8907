"""Synthetic genomes and read banks, made on the device from the seed.

Frozen copies of ``chip_smoke.py``'s bank generators (``bench_reads``,
``error_reads``, ``write_reads``), rewritten for a ``torch.Generator`` so
that a 100x bacterial bank is made in a few large calls on the card, and
extended to reads from both strands and to FASTQ. The same seed on the
same device gives the same genome, reads and batches, so the plain
reference makes its inputs again after the window instead of keeping
them.

Codes are GATB's: A=0, C=1, T=2, G=3; the complement of ``c`` is ``c ^ 2``.
"""

from __future__ import annotations

import os

import torch

NTS = b"ACTG"
READ_CHUNK = 1 << 19          # reads made per call


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def genome(gen: torch.Generator, config: dict, device) -> torch.Tensor:
    """(genome_len,) uint8 codes: uniform, with the configuration's
    interspersed ``repeats`` (where it has them) laid into it."""
    g = torch.randint(0, 4, (config["genome_len"],), generator=gen,
                      dtype=torch.uint8, device=device)
    if config.get("repeats"):
        lay_repeats(gen, g, config["repeats"]["families"])
    return g


def _copies(gen, fam: dict, target: int, cons_at: int, device):
    """One family's copies: (lengths, consensus offsets, divergences),
    drawn until they cover ``target`` bases. A copy's length is uniform
    with the family's mean copy length (the table's Mb over its copies),
    at most the consensus; LINEs (``keep_3prime``) keep their 3' end, the
    others a fragment at a uniform place."""
    c = fam["consensus_len"]
    mean = fam["mb"] * 1e6 / fam["copies"]
    lo = max(1, int(round(2 * mean - c)))
    hi = int(round(2 * mean)) - lo
    n = int(1.5 * target / mean) + 16
    lens = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    lens = lens[:int((lens.cumsum(0) <= target).sum())]
    n = lens.numel()
    which = torch.randint(0, fam["consensi"], (n,), generator=gen,
                          device=device)
    if fam["keep_3prime"]:
        start = c - lens
    else:
        start = torch.minimum((torch.rand((n,), generator=gen, device=device)
                               * (c - lens + 1)).long(), c - lens)
    d0, d1 = fam["divergence"]
    div = d0 + (d1 - d0) * torch.rand((n,), generator=gen, device=device)
    return lens, cons_at + which * c + start, div


def lay_repeats(gen, g: torch.Tensor, families: list) -> None:
    """Lay copies of each family's consensus sequences into ``g``, each
    family over its ``share`` of the genome: every copy on a strand by a
    coin, each of its bases substituted with the copy's divergence, the
    copies in a random order between unique stretches of uniform length.
    All in a few large calls on ``g``'s device; copies never overlap, so
    the genome is the same on every call with the same generator."""
    dev = g.device
    size = sum(f["consensi"] * f["consensus_len"] for f in families)
    cons = torch.randint(0, 4, (size,), generator=gen, dtype=torch.uint8,
                         device=dev)
    parts, at = [], 0
    for f in families:
        parts.append(_copies(gen, f, int(round(f["share"] * g.numel())),
                             at, dev))
        at += f["consensi"] * f["consensus_len"]
    lens, off, div = (torch.cat(x) for x in zip(*parts))
    order = torch.randperm(lens.numel(), generator=gen, device=dev)
    lens, off, div = lens[order], off[order], div[order]
    n, total = lens.numel(), int(lens.sum())
    unique = g.numel() - total
    if unique < 0:
        raise ValueError("the repeats' shares add up to more than 1")
    flip = torch.rand((n,), generator=gen, device=dev) < 0.5
    cuts = torch.randint(0, unique + 1, (n,), generator=gen,
                         device=dev).sort().values
    first = lens.cumsum(0) - lens
    copy = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    j = torch.arange(total, device=dev) - first[copy]
    src = torch.where(flip[copy], lens[copy] - 1 - j, j)
    base = cons[off[copy] + src] ^ (flip[copy].to(torch.uint8) * 2)
    hit = torch.rand((total,), generator=gen, device=dev) < div[copy]
    shift = torch.randint(1, 4, (total,), generator=gen, dtype=torch.uint8,
                          device=dev)
    g[cuts[copy] + first[copy] + j] = torch.where(hit, (base + shift) & 3,
                                                  base)


def reads(gen: torch.Generator, seq: torch.Tensor, n_reads: int,
          read_len: int, error_rate: float, both_strands: bool):
    """Yield (n, read_len) uint8 blocks of reads drawn uniformly from
    ``seq``; with ``both_strands`` half of them (by a coin per read) are
    reverse-complemented; then each base is replaced, with probability
    ``error_rate``, by one of the other three."""
    dev = seq.device
    span = torch.arange(read_len, device=dev)
    for start in range(0, n_reads, READ_CHUNK):
        m = min(READ_CHUNK, n_reads - start)
        starts = torch.randint(0, seq.numel() - read_len + 1, (m,),
                               generator=gen, device=dev)
        r = seq[starts[:, None] + span[None, :]]
        if both_strands:
            flip = torch.rand((m,), generator=gen, device=dev) < 0.5
            r = torch.where(flip[:, None], r.flip(1) ^ 2, r)
        hit = torch.rand((m, read_len), generator=gen, device=dev) \
            < error_rate
        shift = torch.randint(1, 4, (m, read_len), generator=gen,
                              dtype=torch.uint8, device=dev)
        yield torch.where(hit, (r + shift) & 3, r)


def n_reads(config: dict) -> int:
    """Reads for the configured coverage: genome x coverage / read
    length, rounded."""
    return int(round(config["genome_len"] * config["coverage"]
                     / config["read_len"]))


def bank_blocks(config: dict, seed: int, device):
    """The configured bank as it is written: (generator, genome, iterator
    over blocks of reads). The generator is left where the bank's reads
    end, for the caller's further draws (the query cell's batches)."""
    gen = generator(seed, device)
    g = genome(gen, config, device)
    blocks = reads(gen, g, n_reads(config), config["read_len"],
                   config["error_rate"], config["strands"] == "both")
    return gen, g, blocks


def fastq_records(codes: torch.Tensor, first_index: int, width: int,
                  quality: str) -> torch.Tensor:
    """(n, 2L + width + 7) uint8 FASTQ records, laid out on the codes'
    device: '@r<index, zero-padded to width>\\n<seq>\\n+\\n<qual>\\n'."""
    n, length = codes.shape
    dev = codes.device
    rec = torch.empty((n, 2 * length + width + 7), dtype=torch.uint8,
                      device=dev)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("r")
    idx = torch.arange(first_index, first_index + n, device=dev)
    for t in range(width):
        rec[:, 2 + t] = (48 + (idx // 10 ** (width - 1 - t)) % 10) \
            .to(torch.uint8)
    rec[:, 2 + width] = 10
    s = 3 + width
    rec[:, s:s + length] = torch.tensor(list(NTS), dtype=torch.uint8,
                                        device=dev)[codes.long()]
    rec[:, s + length] = 10
    rec[:, s + length + 1] = ord("+")
    rec[:, s + length + 2] = 10
    rec[:, s + length + 3:s + 2 * length + 3] = ord(quality)
    rec[:, -1] = 10
    return rec


def write_bank(path: str, config: dict, blocks) -> int:
    """Write the bank's reads to ``path`` as FASTQ with a constant
    quality, and flush it to the disk (so that no write-back of it runs
    in the measured window); returns the bytes written."""
    if config["bank_format"] != "fastq":
        raise ValueError(f"unknown bank_format {config['bank_format']!r}")
    width = len(str(max(n_reads(config) - 1, 0)))
    done = 0
    written = 0
    with open(path, "wb") as f:
        for block in blocks:
            rec = fastq_records(block, done, width, config["quality"])
            buf = rec.cpu().numpy().tobytes()
            f.write(buf)
            written += len(buf)
            done += block.shape[0]
        f.flush()
        os.fsync(f.fileno())
    return written
