"""The benchmark of `speechless_tpu_torch` on one H100: `run.py` runs one cell once."""
