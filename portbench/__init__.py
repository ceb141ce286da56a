"""The benchmark of tfrec_tpu_torch on one NVIDIA H100 (``run.py``)."""
