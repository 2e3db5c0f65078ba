"""Plain PyTorch references of the served model families, one module a
family (``bench/reference/<family>.py``, named by a configuration's
``check.reference``), each with ``forward(weights, sizes, tokens, n_out,
quant=False)``. They import nothing of the program."""
