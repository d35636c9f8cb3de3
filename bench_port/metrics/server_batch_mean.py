"""server_batch_mean: requests per micro-batch, from SearchServer.stats over
the window."""


def read(run):
    if not run.stats["batches"]:
        return None
    return run.stats["requests"] / run.stats["batches"]
