"""Benchmarks of the port (port of the reference's ``benchmarks/``): the
same row names and CSV format, run on the card unless ``--device cpu``.
``python -m repro_torch.benchmarks.run --only kernel`` is the entry point."""
