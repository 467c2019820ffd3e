"""multih_tpu_torch: the Multi-H fit in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the JAX package ``multih_tpu`` (the reference), laid out
like it module for module. It imports torch, numpy and scipy, never JAX.
"""

from multih_tpu_torch.config import MultiHConfig
from multih_tpu_torch.models.pipeline import (
    FitResult,
    estimate_tau,
    fit,
    fit_adaptive,
    make_fit,
    make_fit_adaptive,
    make_fit_seeded,
    make_fit_tau,
    pad_points,
)

__all__ = [
    "MultiHConfig",
    "FitResult",
    "estimate_tau",
    "fit",
    "fit_adaptive",
    "make_fit",
    "make_fit_adaptive",
    "make_fit_seeded",
    "make_fit_tau",
    "pad_points",
]
