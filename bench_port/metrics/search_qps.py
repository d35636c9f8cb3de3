"""search_qps: text queries answered in the window (a failed or refused
request is not answered) over the window's seconds, by the host clock."""


def read(run):
    return run.answered / run.window_s
