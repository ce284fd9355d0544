"""Plain references of what a cell's timed path produces: the decode
logits of each architecture (``transformer``, ``mamba1``), computed from
the published configuration, and the serving plan
(``plan``).  Plain PyTorch and NumPy; nothing of the program."""
