"""Entry points of the port (port of ``repro/launch/``): the serving
entry point `serve.py`, the step builders `steps.py` and the training
driver `train.py`."""
