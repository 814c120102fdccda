"""The benchmark of openibl_tpu_torch on one H100 (see run.py)."""
