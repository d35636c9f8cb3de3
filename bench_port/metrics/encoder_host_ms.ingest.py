"""encoder_host_ms.ingest: the host milliseconds each batch spends inside
encode_stream (waiting for the oldest batch in flight included), by the
harness's clock, averaged over the window's batches."""


def read(run):
    if not run.host_ms:
        return None
    return sum(run.host_ms) / len(run.host_ms)
