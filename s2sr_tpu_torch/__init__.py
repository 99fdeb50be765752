"""s2sr_tpu_torch — the PyTorch / CUDA port of s2sr_tpu for NVIDIA Hopper.

A second package beside the JAX one. It imports ``torch`` and never
``jax``, and nothing of ``s2sr_tpu``: what it needs from there it keeps
as its own copy. The JAX package is the numerical reference the port's
tests hold it against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise instead of falling back.

Layout:
    config/     settings dataclass
    utils/      logging, stage timing, files/JSON, request validation
    geo/        affine, CRS math, GeoTIFF codec (numpy), device warp
    fetch/      seeded synthetic scenes, offline scene selection
    models/     registry, weights, RRDBNet, SwinIR, SREngine
    ops/        kernel wrappers + WOW/farm colour/CLAHE/blur chains
    csrc/       hand-written CUDA C++ kernels (sm_90a)
    parallel/   halo tiling
    tiles/      PNG codec, mercator math, XYZ pyramid
    pipelines/  raster I/O, WOW and farm SR pipelines
    server/     HTTP framework, job store/runner/journal, the API app
    bench/      RDB ladder, matrix-unit benchmark, cuBLAS peak
    cli/        command line entry points
"""

__version__ = "0.1.0"
