"""Entry points of the port (port of ``repro/launch/``): the serving
entry point `serve.py`."""
