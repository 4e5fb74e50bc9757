"""The benchmark of hold_tpu_torch (see README.md)."""
