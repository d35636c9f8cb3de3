"""embed_img_per_s: images whose embeddings came back to the host in the
window over the window's seconds (whole batches over exactly their time)."""


def read(run):
    return run.images / run.window_s
