"""The benchmark of the PyTorch/CUDA port: a cell is run by ``bench/run.py``."""
