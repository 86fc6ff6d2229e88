"""ladder.encode.ms_per_batch: the program's ``ladder.encode`` spans (each
lexical query encode a serving ladder makes: once a batch on the supertile
ladder, once a rung on the impact ladder; host clock) summed over the
traced window and divided by its batches."""


def read(run):
    spans = run.spans.get("ladder.encode")
    if not spans or not run.latencies_s:
        return None
    return 1e3 * sum(spans) / len(run.latencies_s)
