"""The benchmark of the PyTorch / CUDA port (``wdbx_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json``; ``control.py`` reads
the program's and the control's numbers that the limits of ``correct``
were set from. Nothing here imports JAX or the JAX package.
"""
