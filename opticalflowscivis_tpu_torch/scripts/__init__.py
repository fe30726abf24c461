"""Runnable scripts of the port (``python -m opticalflowscivis_tpu_torch.scripts.<name>``)."""
