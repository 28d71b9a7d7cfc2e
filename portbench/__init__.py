"""The benchmark of the PyTorch/CUDA port (``lzs_tpu_torch``).

``python3 -m portbench.run`` runs one cell of ``BENCHMARK.json`` once
(see ``portbench/run.py``); ``python3 -m portbench.control`` reads each
cell's check on its control; ``python -m pytest portbench/tests`` runs
the harness's CPU tests. Nothing here imports JAX or the JAX package.
"""
