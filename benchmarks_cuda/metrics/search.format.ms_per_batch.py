"""search.format.ms_per_batch: the program's ``search.format`` span
(``Searcher.search_batch``: the top-k to the host, then the Python loop
that builds the rows; host clock) summed over the traced window and
divided by its batches."""


def read(run):
    spans = run.spans.get("search.format")
    if not spans or not run.latencies_s:
        return None
    return 1e3 * sum(spans) / len(run.latencies_s)
