"""search.unspanned.ms_per_batch: host time inside ``Searcher.search_batch``
that no span names: the program's ``search_batch`` span less every leaf
span under it on the ladder routes, summed over the traced window and
divided by its batches."""

LEAVES = ("encode", "ladder.setup", "ladder.encode", "ladder.prefix", "ladder.rung",
          "ladder.merge", "ladder.escalate", "search.format")


def read(run):
    spans = run.spans.get("search_batch")
    if not spans or not run.latencies_s:
        return None
    leaves = sum(sum(run.spans.get(name, ())) for name in LEAVES)
    return 1e3 * (sum(spans) - leaves) / len(run.latencies_s)
