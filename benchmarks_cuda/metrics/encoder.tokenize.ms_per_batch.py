"""encoder.tokenize.ms_per_batch: the program's ``encoder.tokenize`` spans
(inside ``Searcher.search_batch``'s ``encode``: the DeepSeek-V2 encoder's
word split and hashing, its chunk plan and the copy of each chunk's index
to the card; host clock) summed over the traced window and divided by its
batches."""


def read(run):
    spans = run.spans.get("encoder.tokenize")
    if not spans or not run.latencies_s:
        return None
    return 1e3 * sum(spans) / len(run.latencies_s)
