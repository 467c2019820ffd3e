"""multih_tpu_torch: the Multi-H fit in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of the JAX package ``multih_tpu`` (the reference), laid out
like it module for module. It imports torch, numpy and scipy, never JAX.
"""

from multih_tpu_torch.config import MultiHConfig
from multih_tpu_torch.models.mixed import (
    MixedFitResult,
    estimate_tau_mixed,
    fit_mixed,
    fit_mixed_adaptive,
    make_fit_mixed,
    make_fit_mixed_adaptive,
    make_fit_mixed_tau,
)
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
    "MixedFitResult",
    "estimate_tau",
    "estimate_tau_mixed",
    "fit",
    "fit_adaptive",
    "fit_mixed",
    "fit_mixed_adaptive",
    "make_fit",
    "make_fit_adaptive",
    "make_fit_mixed",
    "make_fit_mixed_adaptive",
    "make_fit_mixed_tau",
    "make_fit_seeded",
    "make_fit_tau",
    "pad_points",
]
