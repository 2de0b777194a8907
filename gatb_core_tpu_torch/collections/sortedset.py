"""Sorted-k-mer-set membership and rank: the exact-membership container.

Port of gatb_core_tpu/collections/sortedset.py. Plays two reference roles
at once:
  - ContainerSet (tools/collections/impl/ContainerSet.hpp:51): sorted-vector
    membership via binary search (used for the cFP set);
  - the MPHF index (kmer/impl/MPHFAlgorithm.cpp + BooPHF): for a *static
    sorted* set, rank-in-table is a minimal perfect hash 'getCode': every
    per-node array (abundance, node state, adjacency) is indexed by it.

The search itself is ``ops/rank_search.rank_rows`` (a CUDA kernel on a CUDA
tensor, its plain walk on a CPU tensor), through the set's own
``RankIndex``, built once; ``_searchsorted_limbs`` keeps
the JAX module's lower-bound function for callers that want the insertion
point.
"""

from __future__ import annotations

import torch

from ..ops.rank_search import RankIndex, as_rows, lower_bound_rows


def _searchsorted_limbs(table: torch.Tensor, queries: torch.Tensor,
                        n_table: int) -> torch.Tensor:
    """Lower-bound index of each query row in the sorted limb table.

    table: (C, W) sorted ascending with possible all-ones padding rows
    beyond n_table; queries: (Q, W). Returns (Q,) int32 in [0, n_table].
    Torch ops on the tensors' device (a gather per halving)."""
    return lower_bound_rows(as_rows(table), as_rows(queries),
                            int(n_table)).to(torch.int32)


class SortedKmerSet:
    """Device-resident sorted k-mer set with rank/membership queries.
    ``limbs`` is kept as contiguous (C, W) int32 storage on its device;
    ``index``, the ``RankIndex`` every search of the set walks, is built
    at its first use and kept."""

    def __init__(self, limbs: torch.Tensor, n: int):
        self.limbs = as_rows(limbs)
        self.n = int(n)
        self._index = None

    @property
    def width(self) -> int:
        return self.limbs.shape[1]

    @property
    def index(self) -> RankIndex:
        if self._index is None:
            self._index = RankIndex(self.limbs, self.n)
        return self._index

    def rank(self, queries: torch.Tensor) -> torch.Tensor:
        """(Q, W) -> (Q,) int32: index in table if present, else -1.

        The index is the MPHF code of the k-mer (stable, dense in [0, n)).
        """
        from ..ops.sortops import rank_limbs

        rank, _ = rank_limbs(self.limbs, queries.to(self.limbs.device),
                             self.n, index=self.index)
        return rank

    def contains(self, queries: torch.Tensor) -> torch.Tensor:
        return self.rank(queries) >= 0
