"""s2sr_tpu_torch — the PyTorch / CUDA port of s2sr_tpu for NVIDIA Hopper.

A second package beside the JAX one. It imports ``torch`` and never
``jax``, and nothing of ``s2sr_tpu``: what it needs from there it keeps
as its own copy. The JAX package is the numerical reference the port's
tests hold it against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back.

Layout (this slice: the ``/api/wow`` x4 SR path):
    config/     settings dataclass
    utils/      logging, stage timing
    geo/        affine, CRS math, GeoTIFF codec (numpy)
    fetch/      seeded synthetic scenes
    models/     registry, weights, RRDBNet, SREngine
    ops/        fused RDB kernel wrapper + WOW colour/CLAHE/blur chain
    csrc/       hand-written CUDA C++ kernels (sm_90a)
    parallel/   halo tiling
    tiles/      pure-Python PNG encoder
    pipelines/  raster I/O, WOW SR pipeline
    cli/        command line entry points
"""

__version__ = "0.1.0"
