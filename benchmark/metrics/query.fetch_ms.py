"""The query API's answers to the host per batch: ``.cpu().numpy()`` of
the ranks and of the masks, which waits for the card (the self time of
the program's ``query.fetch`` spans under ``node_index`` and
``adjacency_masks``), in ms."""

from benchmark import spans


def read(run):
    s = spans.per_step(run, ["query.fetch"], within=spans.QUERY_CALLS)
    return None if s is None else s * 1e3
