"""The benchmark of the PyTorch and CUDA port (``python -m portbench.run``)."""
