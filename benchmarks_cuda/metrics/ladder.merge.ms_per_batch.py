"""ladder.merge.ms_per_batch: the program's ``ladder.merge`` spans (each
rung's rows brought to the host: the wait for the card, then the copies;
host clock) summed over the traced window and divided by its batches."""


def read(run):
    spans = run.spans.get("ladder.merge")
    if not spans or not run.latencies_s:
        return None
    return 1e3 * sum(spans) / len(run.latencies_s)
