"""encode.ms_per_batch: the mean of the program's ``encode`` span
(``Searcher.search_batch``'s ``trace_span("encode")``, host clock, not
waiting for the card) over the traced window's batches."""


def read(run):
    spans = run.spans.get("encode")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
