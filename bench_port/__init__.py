"""The benchmark of echopype_torch on NVIDIA cards (``python3 bench_port/run.py``)."""
