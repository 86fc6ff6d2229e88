"""encoder.forward.ms_per_batch: the program's ``encoder.forward`` spans
(inside ``Searcher.search_batch``'s ``encode``: the launches of the
DeepSeek-V2 trunk's forward over each chunk, and any wait inside them;
host clock) summed over the traced window and divided by its batches."""


def read(run):
    spans = run.spans.get("encoder.forward")
    if not spans or not run.latencies_s:
        return None
    return 1e3 * sum(spans) / len(run.latencies_s)
