"""The benchmark of ``tgm_tpu_torch`` on one NVIDIA H100 (see ``run.py``)."""
