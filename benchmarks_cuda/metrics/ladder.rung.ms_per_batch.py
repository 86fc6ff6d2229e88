"""ladder.rung.ms_per_batch: the program's ``ladder.rung`` spans (the host
time to issue each rung's device work, with any wait inside the rung's
ops; host clock) summed over the traced window and divided by its
batches."""


def read(run):
    spans = run.spans.get("ladder.rung")
    if not spans or not run.latencies_s:
        return None
    return 1e3 * sum(spans) / len(run.latencies_s)
