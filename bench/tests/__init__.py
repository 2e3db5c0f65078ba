"""CPU tests of the benchmark (``python -m pytest bench/tests``)."""
