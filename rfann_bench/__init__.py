"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of RNSG.

One cell (a corpus configuration under a traffic mix) runs per process:

    python3 -m rfann_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that defines the yardstick lives here and imports nothing of the
program: the corpus and query generator (``data``), the plain range-filtered
brute force and its lower-precision controls (``reference``), the comparison
that decides ``correct`` (``judge``), the peaks and the scan's least time
(``roofline``) and the reading of the profiler's records (``devtrace``).
"""
