"""The benchmark of phe_tpu_torch, the PyTorch and CUDA port of phe_tpu.

One command runs one cell once (``python3 paillier_bench/run.py``, see
run.py). What a cell is lives in data and in small files found by name:
configurations (``configs/``: deployments, a key and the protocol's
scale), traffic mixes (``traffic/``: parameter files read by the
protocol they name, in ``protocols/``), metric readers (``metrics/``),
the least-work count
(``leastwork.py``) and the plain reference (``reference/``). Nothing here
imports jax or phe_tpu; the program under test is ``phe_tpu_torch``.
"""
