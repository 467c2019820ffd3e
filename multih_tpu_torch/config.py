"""Configuration of the PyTorch port: the JAX package's ``MultiHConfig``
field for field.

The two configs are shared by value — same fields, same defaults — so a
config carries across packages with ``MultiHConfig.from_dict(
dataclasses.asdict(jax_cfg))`` and the parity tests assert the field
lists are equal. The rationale for every default is documented once, in
``multih_tpu/config.py``; the notes here say only what the port reads
differently:

- ``use_pallas``: "use the hand-written CUDA kernels". They run only on
  CUDA tensors (``pipeline._kernels_enabled``); CPU tensors take the
  plain PyTorch paths, as the JAX package's CPU runs take its jnp paths.
- ``knn_approx``: the port always builds the exact k-NN graph
  (``lax.approx_max_k`` is TPU-only and exact on the CPU anyway).
- ``pallas_approx_rcp``: the count kernel multiplies by the hardware
  fast reciprocal (``rcp.approx.ftz.f32``) where the TPU kernel takes
  ``pl.reciprocal(..., approx=True)``; False divides exactly. The plain
  path always divides exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MultiHConfig:
    """All tunables of the pipeline (see ``multih_tpu.config``)."""

    # --- model class ---
    model: Literal["homography", "fundamental"] = "homography"
    f_sample_points: int = 8
    f_split_refine: bool = True
    f_split_iterations: int = 4
    f_exclusive_refine: bool = True
    f_exclusive_iterations: int = 3
    f_resample_lo: bool = True
    f_resample_subsets: int = 16
    f_resample_iterations: int = 2
    f_member_acceptance: bool = True
    f_union_merge: bool = True

    # --- geometry / residuals ---
    inlier_threshold: float = 3.0
    residual: Literal["symmetric", "transfer", "sampson"] = "symmetric"
    rank_residual: Literal["", "symmetric", "transfer", "sampson"] = ""

    # --- hypothesis generation ---
    n_hypotheses: int = 2048
    max_points: int = 512
    progressive_rounds: int = 4
    claims_per_round: int = 1

    # --- candidate selection ---
    n_candidates: int = 256
    lo_rounds: int = 3
    lo_shrink: float = 0.0
    max_labels: int = 16
    nms_iou: float = 0.8
    merge_iou: float = 0.5

    # --- neighborhood graph ---
    knn_k: int = 6
    sampling_motion_weight: float = 2.0
    knn_row_block: int = 0
    claim_subsample: int = 4
    verify_subsample: int = 1
    verify_rescore: int = 4
    knn_approx: bool = True
    knn_window: bool = True
    window_sampling: bool = False
    refit_moments: bool = True
    agree_block: int = 256

    # --- PEARL energy ---
    spatial_weight: float = 0.1
    label_cost: float = 20.0
    outlier_cost: float = 1.0
    pearl_iterations: int = 8
    meanfield_iterations: int = 6
    icm_iterations: int = 2
    temperature: float = 0.25
    temperature_start: float = 2.0
    min_inliers: int = 10

    # --- numerics ---
    dtype: Literal["float32"] = "float32"
    eig_method: Literal["eigh", "jacobi", "inverse_iteration"] = "eigh"
    eig_iterations: int = 6

    # --- execution ---
    spatial_sort: bool = True
    use_pallas: bool = True
    mrf_fused_front: bool = False
    pallas_approx_rcp: bool = True
    residual_chunk: int = 512

    @property
    def minimal_points(self) -> int:
        return 8 if self.model == "fundamental" else 4

    @property
    def lo_shrink_eff(self) -> float:
        if self.lo_shrink > 0.0:
            return self.lo_shrink
        return 1.0 if self.model == "fundamental" else 4.0

    @classmethod
    def from_dict(cls, d: dict) -> "MultiHConfig":
        """Build a port config from ``dataclasses.asdict`` of a JAX
        config (or any dict of the same fields)."""
        return cls(**d)

    def __post_init__(self):
        if self.model not in ("homography", "fundamental"):
            raise ValueError(
                f"model must be 'homography' or 'fundamental', got "
                f"{self.model!r}"
            )
        if self.n_candidates > self.n_hypotheses:
            object.__setattr__(self, "n_candidates", self.n_hypotheses)
        if self.max_labels > self.n_candidates:
            raise ValueError("max_labels must be <= n_candidates")
        if self.model == "fundamental" and self.window_sampling:
            raise ValueError(
                "window_sampling is a homography-path optimization; "
                "disable it for model='fundamental'"
            )
        if self.f_sample_points not in (8, 12):
            raise ValueError("f_sample_points must be 8 or 12")
        if (self.model == "fundamental" and self.f_sample_points == 12
                and self.knn_k < 5):
            raise ValueError(
                "f_sample_points=12 draws two 6-point clusters: "
                "knn_k >= 5 required"
            )


DEFAULT = MultiHConfig()
