"""The port's training substrate (port of ``repro/training/``): the
synthetic token stream, AdamW and checkpoints."""
