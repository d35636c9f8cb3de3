"""The benchmark of the PyTorch and CUDA port (`image_retrieval_tpu_torch`):
the harness, its cells' data, the reference that decides `correct`, and the
readers of its metrics. `run.py` is the entry point."""
