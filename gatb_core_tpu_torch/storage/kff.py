"""KFF (K-mer File Format) v1.0 writer/reader.

Byte-compatible reimplementation of the reference's KFF count dump
(kmer/impl/CountProcessorDumpKff.hpp + thirdparty/kff-cpp-api/kff_io.cpp):

  header   : "KFF" 0x01 0x00 encoding=0b00011110 uniq=0 canon=0
             + 4-byte BE metadata size (0)
  'v'      : global vars (BE counts/values, names NUL-terminated, in
             std::map order): data_size=4, k, max=1
  'r'      : raw blocks; nb_blocks patched big-endian at close; with
             max=1 each block is one kmer: packed sequence (4 nt/byte,
             remnant nts first in the low bits of byte 0) + 4-byte BE count
  footer   : 'i' index section + 'v' {first_index, footer_size} section
  trailer  : "KFF"

Counts are written in ascending kmer order like the reference dump. The
raw section is packed and parsed with numpy, one fixed-size record per
k-mer (max=1), so tables of millions of k-mers take seconds.
"""

from __future__ import annotations

import struct

import numpy as np

ENCODING = 0b00011110  # A=0 C=1 G=3 T=2 == GATB codes (Data.hpp:185)


def _be(value: int, nbytes: int = 8) -> bytes:
    return int(value).to_bytes(nbytes, "big")


def pack_kmer_bytes(codes: np.ndarray) -> bytes:
    """Pack 2-bit codes (one kmer) like encode_sequence
    (CountProcessorDumpKff.hpp:215-229): remnant first, 4 nt/byte."""
    k = len(codes)
    remnant = k % 4
    out = bytearray()
    i = 0
    if remnant:
        val = 0
        for c in codes[:remnant]:
            val = (val << 2) | int(c)
        out.append(val)
        i = remnant
    while i < k:
        val = 0
        for c in codes[i:i + 4]:
            val = (val << 2) | int(c)
        out.append(val)
        i += 4
    return bytes(out)


def unpack_kmer_bytes(buf: bytes, k: int) -> np.ndarray:
    codes = []
    remnant = k % 4
    idx = 0
    if remnant:
        val = buf[0]
        for j in range(remnant - 1, -1, -1):
            codes.append((val >> (2 * j)) & 3)
        idx = 1
    while len(codes) < k:
        val = buf[idx]
        for j in range(3, -1, -1):
            codes.append((val >> (2 * j)) & 3)
        idx += 1
    return np.asarray(codes[:k], np.uint8)


def limbs_to_codes(kmers_limbs: np.ndarray, k: int) -> np.ndarray:
    """(N, W) big-endian uint32 limbs -> (N, k) uint8 2-bit codes, first
    base first."""
    limbs = np.asarray(kmers_limbs, np.uint32)
    n, w = limbs.shape
    pos = 2 * (k - 1 - np.arange(k))            # bit offset of each base
    return ((limbs[:, w - 1 - pos // 32] >> (pos % 32).astype(np.uint32))
            & np.uint32(3)).astype(np.uint8)


def pack_kmer_records(codes: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """(N, k) codes + (N,) counts -> (N, ceil(k/4) + 4) uint8 raw-section
    records: pack_kmer_bytes of each row, then its 4-byte BE count."""
    n, k = codes.shape
    nb = (k + 3) // 4
    lead = (-k) % 4                              # zero bases ahead: the
    padded = np.zeros((n, nb * 4), np.uint8)     # remnant fills byte 0's
    padded[:, lead:] = codes                     # low bits
    q = padded.reshape(n, nb, 4)
    rec = np.empty((n, nb + 4), np.uint8)
    rec[:, :nb] = (q[:, :, 0] << 6) | (q[:, :, 1] << 4) | (q[:, :, 2] << 2) \
        | q[:, :, 3]
    rec[:, nb:] = np.asarray(counts).astype(">u4").view(np.uint8).reshape(
        n, 4)
    return rec


def write_kff(path: str, kmers_limbs: np.ndarray, counts: np.ndarray,
              k: int, merged_style: bool = True) -> None:
    """Write a solid count table as KFF (CountProcessorDumpKff layout).

    With ``merged_style`` (default), the header flags/metadata and the
    index layout replicate the reference's final artifact — the
    kff-cpp-api *merged* file produced by dbgh5 -kff (uniqueness=1,
    canonicity=1, metadata "Merged file", only 'v' sections indexed) —
    so output is byte-identical to the reference's for the same table.
    """
    with open(path, "wb") as f:
        # --- header -----------------------------------------------------
        flags = 1 if merged_style else 0
        f.write(b"KFF" + bytes([1, 0, ENCODING, flags, flags]))
        metadata = b"Merged file" if merged_style else b""
        f.write(_be(len(metadata), 4))
        f.write(metadata)
        positions = []  # (abs_pos, section_type)

        # --- global variables (std::map order: alphabetical) ------------
        positions.append((f.tell(), "v"))
        f.write(b"v")
        gvars = {"data_size": 4, "k": k, "max": 1}
        f.write(_be(len(gvars)))
        for name in sorted(gvars):
            f.write(name.encode() + b"\0" + _be(gvars[name]))

        # --- raw section (the merge tool indexes only 'v' sections) ------
        if not merged_style:
            positions.append((f.tell(), "r"))
        f.write(b"r")
        nb_blocks_pos = f.tell()
        f.write(_be(0))  # patched below
        # max=1 -> ceil(log2(1))=0 bits -> 0 nb_kmers bytes per block
        n_kmers = len(counts)
        if n_kmers:
            f.write(pack_kmer_records(limbs_to_codes(kmers_limbs, k),
                                      counts).tobytes())
        end = f.tell()
        f.seek(nb_blocks_pos)
        f.write(_be(n_kmers))
        f.seek(end)

        # --- footer: index + footer vars ---------------------------------
        si_beginning = f.tell()
        index_end = si_beginning + 17 + 9 * len(positions)
        f.write(b"i")
        f.write(_be(len(positions)))
        for pos, typ in sorted(positions):
            rel = pos - index_end
            f.write(typ.encode())
            f.write(struct.pack(">q", rel))
        f.write(_be(0))  # next_index
        f.write(b"v")
        fvars = {"first_index": si_beginning, "footer_size": 9 + 2 * (12 + 8)}
        f.write(_be(len(fvars)))
        for name in sorted(fvars):
            f.write(name.encode() + b"\0" + _be(fvars[name]))

        f.write(b"KFF")


def read_kff(path: str):
    """Read back a KFF count file -> (k, [(codes array, count)])."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:3] != b"KFF" or data[-3:] != b"KFF":
        raise ValueError("not a KFF file (missing signatures)")
    encoding = data[5]
    pos = 8
    meta_size = int.from_bytes(data[pos:pos + 4], "big")
    pos += 4 + meta_size
    gvars = {}
    out = []
    k = None
    while pos < len(data) - 3:
        typ = data[pos:pos + 1]
        pos += 1
        if typ == b"v":
            nv = int.from_bytes(data[pos:pos + 8], "big")
            pos += 8
            for _ in range(nv):
                end = data.index(b"\0", pos)
                name = data[pos:end].decode()
                pos = end + 1
                gvars[name] = int.from_bytes(data[pos:pos + 8], "big")
                pos += 8
            k = gvars.get("k", k)
        elif typ == b"r":
            nb = int.from_bytes(data[pos:pos + 8], "big")
            pos += 8
            ds = gvars["data_size"]
            kk = gvars["k"]
            mx = gvars["max"]
            nkb = 0 if mx <= 1 else (max(1, (mx - 1).bit_length()) + 7) // 8
            seq_bytes = (kk + 3) // 4
            if not nkb:
                # max=1: nb fixed-size records, parsed in one piece
                rec = np.frombuffer(data, np.uint8, nb * (seq_bytes + ds),
                                    pos).reshape(nb, seq_bytes + ds)
                pos += rec.size
                q = rec[:, :seq_bytes, None] >> np.array(
                    [6, 4, 2, 0], np.uint8) & np.uint8(3)
                codes = q.reshape(nb, -1)[:, (-kk) % 4:]
                cnts = np.zeros(nb, np.int64)
                for j in range(ds):
                    cnts = (cnts << 8) | rec[:, seq_bytes + j]
                out.extend(zip(codes, cnts.tolist()))
                nb = 0
            for _ in range(nb):
                nkm = 1
                if nkb:
                    nkm = int.from_bytes(data[pos:pos + nkb], "big")
                    pos += nkb
                sb = (kk + nkm - 1 + 3) // 4
                codes = unpack_kmer_bytes(data[pos:pos + sb], kk + nkm - 1)
                pos += sb
                cnt = int.from_bytes(data[pos:pos + ds], "big")
                pos += ds * nkm
                out.append((codes, cnt))
        elif typ == b"i":
            nv = int.from_bytes(data[pos:pos + 8], "big")
            pos += 8 + 9 * nv + 8
        else:
            raise ValueError(f"unknown KFF section {typ!r}")
        if gvars.get("first_index") is not None and typ == b"v" \
                and "footer_size" in gvars:
            break
    return k, out, encoding
