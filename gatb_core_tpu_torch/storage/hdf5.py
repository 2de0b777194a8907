"""Persistent hierarchical storage: HDF5-backed Storage/Group tree.

Port of gatb_core_tpu/storage/hdf5.py (host code: numpy and h5py; the
Bloom and MPHF loaders put their tensors on the device asked for). h5py is
imported when a Storage is opened, so the module imports where h5py is not
installed.

Equivalent of gatb-core's storage layer (tools/storage/impl/
Storage.hpp:166-669, StorageHDF5.hpp): a Storage is a tree of Groups holding
typed collections (datasets) and string properties; every algorithm persists
its artifacts into a group, and the file doubles as the checkpoint for
stage-wise resume (Graph 'state' property, debruijn/impl/Graph.hpp:1010-1030).

Layout written for a graph build (matches the reference structure,
Graph.cpp:424-428 + CountProcessorDump.hpp:94 + CountProcessorHistogram.hpp:147):

  /                    attrs: state, kmer_size, nb_solid_kmers
  /configuration       attr 'xml' = config dump
  /dsk/solid           dataset: compound {value: uint64[words], abundance: i32}
  /histogram/histogram dataset: compound {index: u64, abundance: u64}
  /histogram/cutoff    dataset: u64[1]
  /minimizers          repartition table
  /bloom               dataset 'bloom' (uint32 words) + size/hash/kind attrs
  /debloom             datasets cfp, cfp_all; group cascading (bloom2-4, t4)
  /adjacency/masks     uint8 per node
  /branching/nodes     compound {value, abundance} of the branching nodes
  /mphf                BooPHF levels + the discretized abundance map
  /dsk/mphf            the reference BooPHF byte stream (up to 4M keys)

Mapping note: k-mer values are stored as little-endian uint64 word arrays,
the exact in-memory layout of the reference's LargeInt<words>
(tools/math/LargeInt.hpp), converted from the engine's big-endian uint32
limbs.
"""

from __future__ import annotations

import numpy as np

# Graph build state bits (debruijn/impl/Graph.hpp:1010-1030)
STATE_INIT_DONE = 1 << 0
STATE_CONFIGURATION_DONE = 1 << 1
STATE_SORTING_COUNT_DONE = 1 << 2
STATE_BLOOM_DONE = 1 << 3
STATE_DEBLOOM_DONE = 1 << 4
STATE_BRANCHING_DONE = 1 << 5
STATE_MPHF_DONE = 1 << 6
STATE_ADJACENCY_DONE = 1 << 7
STATE_NONSIMPLE_CACHE = 1 << 8


def limbs_to_words64(limbs: np.ndarray) -> np.ndarray:
    """(N, W32) big-endian uint32 limbs -> (N, words) little-endian uint64
    words (reference LargeInt layout)."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    n, w32 = limbs.shape
    if w32 % 2:  # pad a zero most-significant limb
        limbs = np.concatenate(
            [np.zeros((n, 1), np.uint32), limbs], axis=1)
        w32 += 1
    words = w32 // 2
    le = limbs[:, ::-1].astype(np.uint64)  # little-endian u32 order
    out = np.zeros((n, words), np.uint64)
    for j in range(words):
        out[:, j] = le[:, 2 * j] | (le[:, 2 * j + 1] << np.uint64(32))
    return out


def words64_to_limbs(words: np.ndarray, w32: int) -> np.ndarray:
    """Inverse of limbs_to_words64. Accepts (N,) for single-word values
    (the reference stores LargeInt<1> as scalar u64 columns)."""
    words = np.asarray(words, dtype=np.uint64)
    if words.ndim == 1:
        words = words[:, None]
    n, nw = words.shape
    le = np.zeros((n, 2 * nw), np.uint32)
    for j in range(nw):
        le[:, 2 * j] = (words[:, j] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        le[:, 2 * j + 1] = (words[:, j] >> np.uint64(32)).astype(np.uint32)
    be = le[:, ::-1]
    return be[:, -w32:] if be.shape[1] >= w32 else np.concatenate(
        [np.zeros((n, w32 - be.shape[1]), np.uint32), be], axis=1)


class Group:
    """Thin wrapper over an h5py group with reference-style properties."""

    def __init__(self, h5group):
        self._g = h5group

    def group(self, name: str) -> "Group":
        if name in self._g:
            return Group(self._g[name])
        return Group(self._g.create_group(name))

    def set_property(self, key: str, value) -> None:
        self._g.attrs[key] = value

    def get_property(self, key: str, default=None):
        return self._g.attrs.get(key, default)

    # gzip only small datasets: the reference stores every collection
    # UNCOMPRESSED (verified on its dbgh5 output), and compressing a
    # solid table of hundreds of MB is pure loss against the reference's
    # contiguous write
    COMPRESS_MAX_BYTES = 8 << 20

    def set_dataset(self, name: str, data: np.ndarray) -> None:
        if name in self._g:
            del self._g[name]
        data = np.asarray(data)
        if data.nbytes <= self.COMPRESS_MAX_BYTES:
            self._g.create_dataset(name, data=data, compression="gzip",
                                   compression_opts=1)
        else:
            self._g.create_dataset(name, data=data)

    def get_dataset(self, name: str) -> np.ndarray | None:
        if name not in self._g:
            return None
        return self._g[name][...]

    def __contains__(self, name: str) -> bool:
        return name in self._g

    def ostream(self, name: str) -> "OStream":
        """Raw byte output stream (Storage::ostream equivalent)."""
        return OStream(self, name)

    def istream(self, name: str) -> "IStream":
        """Raw byte input stream (Storage::istream equivalent)."""
        return IStream(self, name)


class OStream:
    """Raw byte output stream inside a Group (Storage::ostream,
    tools/storage/impl/Storage.cpp — used by Repartitor::save /
    Configuration::save in the reference; Leon block streams here)."""

    def __init__(self, group: "Group", name: str):
        self._group = group
        self._name = name
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data

    def flush(self) -> None:
        self._group.set_dataset(self._name,
                                np.frombuffer(bytes(self._buf), np.uint8))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()


class IStream:
    """Raw byte input stream over a Group dataset (Storage::istream)."""

    def __init__(self, group: "Group", name: str):
        data = group.get_dataset(name)
        self._data = b"" if data is None else np.asarray(data).tobytes()
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = len(self._data) - self._pos
        out = self._data[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def seek(self, pos: int) -> None:
        self._pos = pos

    def tell(self) -> int:
        return self._pos


class Storage(Group):
    """HDF5 storage root (StorageFactory STORAGE_HDF5 equivalent)."""

    def __init__(self, path: str, mode: str = "a"):
        import h5py

        self._f = h5py.File(path, mode)
        super().__init__(self._f)
        self.path = path

    def close(self) -> None:
        self._f.close()

    def flush(self) -> None:
        self._f.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- graph-build state machine helpers ---------------------------
    def get_state(self) -> int:
        return prop_int(self, "state", 0)

    def set_state_bit(self, bit: int) -> None:
        self.set_property("state", np.uint64(self.get_state() | bit))

    def check_state(self, bit: int) -> bool:
        return bool(self.get_state() & bit)


def count_dtype(words: int) -> np.dtype:
    """Compound dtype of a Count record {value, abundance}
    (kmer/impl/Model.hpp:1568-1590)."""
    return np.dtype([("value", np.uint64, (words,)), ("abundance", np.int32)])


def save_solid(storage: Storage, kmers_limbs: np.ndarray,
               counts: np.ndarray, kmer_size: int) -> None:
    """Write the solid count table into /dsk/solid."""
    words = max(1, (kmer_size + 31) // 32)
    vals = limbs_to_words64(kmers_limbs)
    if vals.shape[1] < words:
        vals = np.concatenate(
            [vals, np.zeros((len(vals), words - vals.shape[1]), np.uint64)],
            axis=1)
    rec = np.zeros(len(counts), dtype=count_dtype(words))
    rec["value"] = vals[:, :words]
    rec["abundance"] = counts
    dsk = storage.group("dsk")
    dsk.set_dataset("solid", rec)
    dsk.set_property("nb_items", np.uint64(len(rec)))
    storage.set_property("nb_solid_kmers", np.uint64(len(rec)))
    storage.set_property("kmer_size", np.uint64(kmer_size))
    storage.set_state_bit(STATE_SORTING_COUNT_DONE)


def _read_count_records(ds) -> np.ndarray:
    """Read one Count dataset, tolerating the reference's >64-bit value
    fields. At k>32 spans the reference writes `value` as an HDF5
    native int128/int256 (LargeInt<words>, CountProcessorDump.hpp:94)
    which h5py cannot map to a numpy dtype ('<i16' TypeError); the raw
    chunk bytes are then parsed directly — value = little-endian u64
    words at offset 0, abundance i32 after them (+ struct padding)."""
    try:
        return ds[...]
    except TypeError:
        pass
    sid = ds.id
    t = sid.get_type()
    itemsize = t.get_size()
    val_bytes = t.get_member_type(0).get_size()
    words = val_bytes // 8
    n = ds.shape[0]
    import zlib

    plist = sid.get_create_plist()
    if plist.get_layout() == 2:     # chunked
        chunks = []
        for ci in range(sid.get_num_chunks()):
            info = sid.get_chunk_info(ci)
            _, raw = sid.read_direct_chunk(info.chunk_offset)
            if ds.compression == "gzip":
                raw = zlib.decompress(raw)
            chunks.append((info.chunk_offset[0], raw))
        chunks.sort()
        buf = b"".join(raw for _, raw in chunks)
    else:                            # contiguous
        off = sid.get_offset()
        with open(ds.file.filename, "rb") as f:
            f.seek(off)
            buf = f.read(n * itemsize)
    dt = np.dtype({"names": ["value", "abundance"],
                   "formats": [("<u8", (words,)), "<i4"],
                   "offsets": [0, val_bytes], "itemsize": itemsize})
    return np.frombuffer(buf, dtype=dt)[:n]


def load_solid(storage: Storage):
    """Read /dsk/solid back as (limbs uint32 (N,W32), counts int32).

    Handles both this engine's layout (one dataset) and a reference
    dbgh5 .h5, where dsk/solid is a Partition group of per-minimizer-
    partition datasets 0..P-1 (CountProcessorDump.hpp:94) that are only
    locally sorted — the concatenation is re-sorted globally."""
    import h5py

    k = prop_int(storage, "kmer_size")
    w32 = (2 * k + 31) // 32
    dsk = storage.group("dsk")
    node = dsk._g.get("solid")
    if isinstance(node, h5py.Group):  # reference partition layout
        parts = sorted(node.keys(), key=int)
        rec = np.concatenate([_read_count_records(node[p])
                              for p in parts]) if parts \
            else np.zeros(0, count_dtype(max(1, (k + 31) // 32)))
        vals = rec["value"]
        if vals.ndim == 1:
            vals = vals[:, None]
        limbs = words64_to_limbs(vals, w32)
        counts = rec["abundance"].astype(np.int32)
        order = np.lexsort(tuple(limbs[:, j]
                                 for j in range(w32 - 1, -1, -1)))
        return limbs[order], counts[order]
    rec = dsk.get_dataset("solid")
    vals = rec["value"]
    if vals.ndim == 1:
        vals = vals[:, None]
    limbs = words64_to_limbs(vals, w32)
    return limbs, rec["abundance"].astype(np.int32)


def save_histogram(storage: Storage, histogram) -> None:
    g = storage.group("histogram")
    pairs = histogram.to_pairs()[1:]  # rows 1..max (reference skips 0,
    # Histogram::save iterates 1.._length, misc/impl/Histogram.cpp)
    # exact reference compound layout: u32 index @0, u64 abundance @8,
    # itemsize 16 (the aligned Entry struct) — byte-comparable datasets
    rec = np.zeros(len(pairs), dtype=np.dtype(
        {"names": ["index", "abundance"],
         "formats": [np.uint32, np.uint64],
         "offsets": [0, 8], "itemsize": 16}))
    rec["index"] = pairs[:, 0]
    rec["abundance"] = pairs[:, 1]
    g.set_dataset("histogram", rec)
    g.set_dataset("cutoff", np.asarray([histogram.cutoff], np.uint64))
    g.set_property("first_peak", np.uint64(histogram.first_peak))


def save_bloom(storage: Storage, bloom) -> None:
    """Write the Bloom filter into /bloom (BloomAlgorithm persistence,
    kmer/impl/BloomAlgorithm.cpp:155-203 saves into group 'bloom')."""
    g = storage.group("bloom")
    _save_bloom_group(g, bloom)
    storage.set_state_bit(STATE_BLOOM_DONE)


def _save_bloom_group(g: Group, bloom) -> None:
    g.set_dataset("bloom", bloom.to_numpy())     # uint32 words
    g.set_property("size_bits", np.uint64(bloom.size_bits))
    g.set_property("nb_hash", np.uint64(bloom.n_hash))
    g.set_property("seed", np.uint64(bloom.user_seed))
    g.set_property("kind", bloom.kind)
    g.set_property("kmer_size", np.uint64(bloom.kmer_size))


def _attr_str(v) -> str:
    """Normalize an HDF5 attribute to str: the reference writes every
    property as a (1,)-shaped vlen string; ours are scalars."""
    if isinstance(v, (np.ndarray, list, tuple)) and len(v) == 1:
        v = v[0]
    return v.decode() if isinstance(v, bytes) else str(v)


def prop_int(g: Group, key: str, default: int = 0) -> int:
    """Integer property tolerant of the reference's string-typed HDF5
    attributes (gatb stores every property as a (1,) vlen string)."""
    v = g.get_property(key, None)
    if v is None:
        return default
    return int(_attr_str(v))


def prop_str(g: Group, key: str, default: str = "") -> str:
    v = g.get_property(key, None)
    return default if v is None else _attr_str(v)


def _bloom_from_words(words: np.ndarray, device, *params):
    """uint32 words (numpy) + (size_bits, n_hash, seed, kind, kmer_size)
    -> the port's BloomFilter with the words on ``device``."""
    from ..collections.bloom import BloomFilter
    from ..convert import u32_to_torch

    return BloomFilter(u32_to_torch(words, device), *params)


def load_bloom_dataset(ds, device="cuda"):
    """Bloom from a reference StorageTools::saveBloom dataset: raw bytes
    with type/size/nb_hash/kmer_size string attrs (StorageTools.hpp:129)."""
    raw = np.asarray(ds[...], np.uint8)
    pad = (-len(raw)) % 4
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    return _bloom_from_words(raw.view("<u4"), device,
                             int(_attr_str(ds.attrs["size"])),
                             int(_attr_str(ds.attrs["nb_hash"])),
                             0, _attr_str(ds.attrs["type"]),
                             int(_attr_str(ds.attrs["kmer_size"])))


def load_bloom_group(g: Group, device="cuda"):
    """Read a Bloom filter from a group holding a 'bloom' dataset (this
    engine's layout, or a reference .h5 where the params ride as string
    attrs on the dataset itself)."""
    if "bloom" not in g:
        return None
    if g.get_property("size_bits") is None:  # reference layout
        return load_bloom_dataset(g._g["bloom"], device)
    return _bloom_from_words(g.get_dataset("bloom"), device,
                             int(g.get_property("size_bits")),
                             int(g.get_property("nb_hash")),
                             int(g.get_property("seed", 0)),
                             str(g.get_property("kind", "basic")),
                             int(g.get_property("kmer_size", 0)))


def load_bloom(storage: Storage, device="cuda"):
    return load_bloom_group(storage.group("bloom"), device)


def _limbs_to_words_padded(limbs: np.ndarray, words: int) -> np.ndarray:
    vals = limbs_to_words64(limbs) if len(limbs) else \
        np.zeros((0, words), np.uint64)
    if vals.shape[1] < words and len(vals):
        vals = np.concatenate(
            [vals, np.zeros((len(vals), words - vals.shape[1]), np.uint64)],
            axis=1)
    return vals[:, :words]


def save_debloom(storage: Storage, cfp_limbs: np.ndarray, kmer_size: int,
                 kind: str = "original", cascade=None) -> None:
    """Write the cFP set into /debloom (DebloomAlgorithm::createCFP,
    kmer/impl/DebloomAlgorithm.cpp:476-600). Like the reference, the
    'cfp' dataset holds the final critical collection (the full set for
    'original', the exact leftover T4 for 'cascading'); 'cfp_all' always
    carries the full cFP set (used for exact-set conformance checks)."""
    g = storage.group("debloom")
    words = max(1, (kmer_size + 31) // 32)
    final_set = cascade.t4 if (kind == "cascading" and cascade is not None) \
        else cfp_limbs
    g.set_dataset("cfp", _limbs_to_words_padded(final_set, words))
    g.set_dataset("cfp_all", _limbs_to_words_padded(cfp_limbs, words))
    g.set_property("nb_cfp", np.uint64(len(cfp_limbs)))
    g.set_property("kind", kind)
    if cascade is not None:
        cg = g.group("cascading")
        cg.set_property("nb_levels", np.uint64(len(cascade.blooms)))
        for i, b in enumerate(cascade.blooms):
            _save_bloom_group(cg.group(f"bloom{i + 2}"), b)
        cg.set_dataset("t4", _limbs_to_words_padded(cascade.t4, words))
    storage.set_state_bit(STATE_DEBLOOM_DONE)


def load_debloom(storage: Storage, w32: int) -> np.ndarray | None:
    """The full cFP set (exactness artifact) from /debloom. On a
    reference .h5 only the final critical collection exists (T4 for
    cascading); it is returned as-is (the cascade blooms carry the rest
    of the membership information)."""
    g = storage.group("debloom")
    rec = g.get_dataset("cfp_all")
    if rec is None:
        rec = g.get_dataset("cfp")
    if rec is None:
        return None
    rec = np.asarray(rec)
    if rec.ndim == 1:
        rec = rec[:, None]
    return words64_to_limbs(rec, w32)


REF_MPHF_STREAM_MAX_KEYS = 4_000_000


def save_mphf(storage: Storage, mphf, abundance_codes: np.ndarray,
              solid_limbs: np.ndarray | None = None,
              kmer_size: int | None = None,
              ref_stream: bool | None = None) -> None:
    """Persist the BooPHF levels + discretized abundance map into /mphf
    (MPHFAlgorithm persistence, kmer/impl/MPHFAlgorithm.cpp:150-330), with
    the dtypes of the JAX package's file (bits uint32, fallback keys
    uint32 rows, prefix / perm / fallback ranks int32). When
    ``solid_limbs`` is given, also write the REFERENCE serialization into
    /dsk/mphf (collections/boophf_ref.RefBooPHF.build, byte-identical to
    the reference binary's own build) so reference tools load the file's
    MPHF.

    ``ref_stream``: write that reference /dsk/mphf stream. Default (None)
    gates at REF_MPHF_STREAM_MAX_KEYS, as the JAX package does: the
    RefBooPHF build is a 25-level sequential numpy pass over all keys,
    minutes of host time at tens of millions of k-mers; set True (or env
    GATB_TORCH_MPHF_REF=1) to force it, False to skip (the port's loader
    uses the /mphf group either way)."""
    from ..convert import u32_to_numpy

    if ref_stream is None:
        import os as _os

        ref_stream = (_os.environ.get("GATB_TORCH_MPHF_REF") == "1"
                      or solid_limbs is None
                      or len(solid_limbs) <= REF_MPHF_STREAM_MAX_KEYS)
    if ref_stream and solid_limbs is not None and kmer_size is not None:
        from ..collections.boophf_ref import RefBooPHF
        from ..collections.boophf_ref import limbs_to_words64 as ref_words

        words = ref_words(np.asarray(solid_limbs, np.uint32), kmer_size)
        ref = RefBooPHF.build(words)
        dsk = storage.group("dsk")
        with dsk.ostream("mphf") as os_:
            os_.write(ref.to_bytes())
        dsk.set_property("nb_keys", str(len(words)))
    g = storage.group("mphf")
    g.set_dataset("bits", u32_to_numpy(mphf.bits))
    g.set_dataset("prefix", mphf.prefix.cpu().numpy())
    g.set_dataset("perm", mphf.perm.cpu().numpy())
    g.set_dataset("fallback_keys", u32_to_numpy(mphf.fallback_keys))
    g.set_dataset("fallback_ranks", mphf.fallback_ranks.cpu().numpy())
    g.set_dataset("abundance", np.asarray(abundance_codes))
    g.set_property("sizes", np.asarray(mphf.sizes, np.uint64))
    g.set_property("offsets", np.asarray(mphf.offsets, np.uint64))
    g.set_property("n", np.uint64(mphf.n))
    storage.set_state_bit(STATE_MPHF_DONE)


def load_mphf(storage: Storage, device="cuda"):
    """(mphf, abundance codes) from /mphf, the BooPHF's tensors on
    ``device``; (None, None) when the group holds no BooPHF. A file in the
    reference's layout keeps its MPHF only as the /dsk/mphf stream, which
    the port does not read back: a lookup through it is host code, and
    Graph.node_index answers through the rank search on the device."""
    import torch

    from ..collections.boophf import BooPHF
    from ..convert import u32_to_torch

    g = storage.group("mphf")
    bits = g.get_dataset("bits")
    if bits is None:
        return None, None

    def ints(name):
        return torch.from_numpy(np.asarray(g.get_dataset(name), np.int32)
                                .copy()).to(device)

    fb_keys = np.asarray(g.get_dataset("fallback_keys"), np.uint32)
    mphf = BooPHF(
        tuple(int(x) for x in g.get_property("sizes")),
        u32_to_torch(bits, device), ints("prefix"),
        tuple(int(x) for x in g.get_property("offsets")),
        u32_to_torch(fb_keys, device),
        ints("fallback_ranks"), ints("perm"), int(g.get_property("n")))
    return mphf, g.get_dataset("abundance")


def save_config(storage: Storage, info: dict) -> None:
    g = storage.group("configuration")
    lines = ["<config>"]
    for key, val in sorted(info.items()):
        lines.append(f"  <{key}>{val}</{key}>")
    lines.append("</config>")
    g.set_property("xml", "\n".join(lines))
    for key, val in info.items():
        if isinstance(val, (int, np.integer)):
            g.set_property(key, np.int64(val))
    storage.set_state_bit(STATE_CONFIGURATION_DONE)
