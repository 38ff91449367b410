"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell is ``python3 omnibench/run.py --workload NAME --seed N --seconds S
--trace 0|1`` from the repository's root (see ``run.py``)."""
