"""The benchmark of the PyTorch port, alifmm_tpu_torch: see run.py."""
