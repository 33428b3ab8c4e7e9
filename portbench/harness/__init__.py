"""The benchmark harness of stenos_tpu_torch (see run.py)."""
