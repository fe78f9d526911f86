"""Benchmarks of the port: the probe that runs its kernels on the card
(``mxu_probe``) and the accuracy protocols (``hi_protocol``, ``bgm_impute``)."""
