"""Benchmarks of the port that run its kernels on the card (``mxu_probe``)."""
