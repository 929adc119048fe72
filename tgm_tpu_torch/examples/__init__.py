"""Example scripts of the port, run as modules (``python -m tgm_tpu_torch.examples...``)."""
