"""The benchmark of zutis_tpu_torch, the PyTorch and CUDA port (harness.py)."""
