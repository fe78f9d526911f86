"""Where the port's CUDA kernels are built (counterpart of
``bayesgm_tpu/utils/cache.py``, which turns on JAX's persistent compilation
cache).

The port's compiled artefacts are the kernel libraries that
``ops/_build.py`` builds with ``nvcc`` on first use, each named by a hash
of its source, so a directory kept between processes is a persistent
cache: a later process loads the libraries instead of building them.  By
default they go to ``build/bayesgm_torch_kernels/`` at the root of the
checkout, which an installed package may not be able to write; this points
them elsewhere.
"""

from __future__ import annotations

import os


def enable_compilation_cache(cache_dir: str | None = None) -> bool:
    """Build and load the kernels in ``cache_dir``, else in
    ``$BAYESGM_TORCH_KERNEL_CACHE``, else in the default directory, and
    create it.  Returns True.  Call it before the first kernel builds;
    calling it again with the same directory does nothing more, and asking
    for another directory after a kernel has loaded raises
    ``RuntimeError``."""
    from bayesgm_torch.ops import _build

    path = cache_dir or os.environ.get("BAYESGM_TORCH_KERNEL_CACHE") or _build.BUILD_DIR
    path = _build.set_build_dir(path)
    path.mkdir(parents=True, exist_ok=True)
    return True
