"""`python -m repro_torch` — the port's experiment CLI (see
repro_torch/experiment/cli.py)."""

import sys

from repro_torch.experiment.cli import main

if __name__ == "__main__":
    sys.exit(main())
