"""Benchmarks of the port's kernels on the card (``python -m
s2sr_tpu_torch.bench.<name>``)."""
