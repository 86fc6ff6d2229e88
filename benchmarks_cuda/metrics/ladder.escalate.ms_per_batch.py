"""ladder.escalate.ms_per_batch: the program's ``ladder.escalate`` spans
(the ladders' host control after each merge: the stop tests, then the
next rung's rows; host clock) summed over the traced window and divided by
its batches."""


def read(run):
    spans = run.spans.get("ladder.escalate")
    if not spans or not run.latencies_s:
        return None
    return 1e3 * sum(spans) / len(run.latencies_s)
