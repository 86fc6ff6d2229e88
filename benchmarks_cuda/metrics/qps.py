"""qps: queries whose results reached the host in the window, over the
window's seconds (host clock; the window ends when the batch that crossed
``--seconds`` has returned its rows)."""


def read(run):
    return run.queries / run.window_s if run.window_s > 0 else None
