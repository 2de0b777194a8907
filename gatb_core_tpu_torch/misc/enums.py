"""Enumerations + CLI flag names.

Ports of gatb-core Enums (tools/misc/api/Enums.hpp:73-271) and the
StringsRepository flag-name registry (api/StringsRepository.hpp:142-165):
every reference CLI flag keeps its exact string so tooling stays
drop-in compatible.
"""

from __future__ import annotations

from enum import Enum


class BloomKind(Enum):
    NONE = "none"
    BASIC = "basic"
    CACHE = "cache"          # default (Enums.hpp)
    NEIGHBOR = "neighbor"

    @classmethod
    def default(cls):
        return cls.CACHE


class DebloomKind(Enum):
    NONE = "none"
    ORIGINAL = "original"
    CASCADING = "cascading"  # default

    @classmethod
    def default(cls):
        return cls.CASCADING


class DebloomImpl(Enum):
    BASIC = "basic"
    MINIMIZER = "minimizer"  # default

    @classmethod
    def default(cls):
        return cls.MINIMIZER


class BranchingKind(Enum):
    NONE = "none"
    STORED = "stored"

    @classmethod
    def default(cls):
        return cls.STORED


class KmerSolidityKind(Enum):
    MIN = "min"
    MAX = "max"
    ONE = "one"
    ALL = "all"
    SUM = "sum"              # default
    CUSTOM = "custom"

    @classmethod
    def default(cls):
        return cls.SUM


def parse_enum(enum_cls, text: str):
    for member in enum_cls:
        if member.value == text:
            return member
    raise ValueError(
        f"unknown {enum_cls.__name__} {text!r} "
        f"(choose from {[m.value for m in enum_cls]})")


# CLI flag strings (StringsRepository.hpp) — exact reference spellings
STR_URI_INPUT = "-in"
STR_URI_OUTPUT = "-out"
STR_URI_OUTPUT_DIR = "-out-dir"
STR_KMER_SIZE = "-kmer-size"
STR_KMER_ABUNDANCE_MIN = "-abundance-min"
STR_KMER_ABUNDANCE_MAX = "-abundance-max"
STR_KMER_ABUNDANCE_MIN_THRESHOLD = "-abundance-min-threshold"
STR_HISTOGRAM_MAX = "-histo-max"
STR_SOLIDITY_KIND = "-solidity-kind"
STR_MINIMIZER_SIZE = "-minimizer-size"
STR_MINIMIZER_TYPE = "-minimizer-type"
STR_REPARTITION_TYPE = "-repartition-type"
STR_NB_CORES = "-nb-cores"
STR_MAX_MEMORY = "-max-memory"
STR_MAX_DISK = "-max-disk"
STR_BLOOM_TYPE = "-bloom"
STR_DEBLOOM_TYPE = "-debloom"
STR_DEBLOOM_IMPL = "-debloom-impl"
STR_BRANCHING_TYPE = "-branching-nodes"
STR_VERBOSE = "-verbose"
