"""The query API's staging per batch: the batch as an array and its
upload, in ``node_index`` and in ``adjacency_masks`` (the self time of
the program's ``query.staging`` spans under those calls), in ms."""

from benchmark import spans


def read(run):
    s = spans.per_step(run, ["query.staging"], within=spans.QUERY_CALLS)
    return None if s is None else s * 1e3
