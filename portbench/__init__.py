"""The benchmark of the PyTorch and CUDA port (``chainermn_tpu_torch``):
one command runs one cell once (``python3 -m portbench.run``).  See
``cell.py`` for how a cell's files are found."""
