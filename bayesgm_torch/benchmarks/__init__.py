"""Benchmarks of the port: the probe that runs its kernels on the card
(``mxu_probe``), the accuracy protocols (``hi_protocol``, ``bgm_impute``)
and the gate runners (``binary_ate``, ``sun_colangelo_ivae``,
``mnist_inpaint``)."""
