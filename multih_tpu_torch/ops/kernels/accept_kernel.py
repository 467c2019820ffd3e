"""The F fit's accept fallback on the card: each step of the
one-model-at-a-time loop of `models.pipeline._f_accept` as K5 between two
hand-written ends (``csrc/accept_kernel.cu``).

Replaces no TPU kernel: the JAX package computes the loop (a lax.scan
over the models, pipeline.py:1556) in plain ops. Step i tries model i's
proposal (or, where `ok_prop[i]` is false, its carried model) under an
ICM relabel from the carried labeling and keeps it where the energy
drops; every step runs, since ICM from the carried labels can lower the
energy where the model is unchanged. A step is three launches:

- `f_accept_front`: the candidate model's residual row, taken from the
  rows the accept was handed (the proposal's `r_prop[i]` where
  `ok_prop[i]`, else the carried `r_c[i]`: row i changes only at step
  i), its data costs and K5's base in the carried (L, N) arrays, and
  K5's two starts (the carried labeling, the first argmin of the
  costs);
- K5, `mrf_kernel.icm_fused`, called through its module attribute as
  every K5 call is, with `best_labeling_t`'s arguments;
- `f_accept_back`: the constant-labeling escape, the start of lowest
  energy and `total_energy_t` (float64 sums over the points rounded to
  float32), the step taken or its row put back.

Its plain version is `pipeline._f_fallback_plain` (the accept's host
route and its card route without the kernels), which returns the same
(Hs, energies, verdicts) and which the card tests hold it to step by
step: the same steps taken, the same energies and models. The wrapper takes CUDA tensors only;
`pipeline._f_accept_kernel_ok` chooses this route exactly where K5 runs
inside the loop's relabel (no 'pt' shard, an adjacency that carries its
neighbour list).
"""

from __future__ import annotations

import torch

from multih_tpu_torch.ops.kernels import _build, mrf_kernel


def f_accept_fallback(Hs_c, r_c, lab_c, e_c, Hs_prop, r_prop, ok_prop,
                      valid, thr, active, adj, spatial_weight: float,
                      outlier_cost: float, label_cost: float,
                      icm_iterations: int):
    """The accept's fallback from the carried (Hs_c (K, 3, 3), r_c (K, N)
    residuals, lab_c (N,) labels, e_c () energy) over the proposals
    (Hs_prop (K, 3, 3), r_prop (K, N) their residuals, ok_prop (K,)
    bool): K steps of front, K5, back.

    valid: (N,) float32; thr: the squared threshold, a 0-dim float32
    tensor; active: (K,) float32; adj: the fit's far-free
    `labeling.BandedAdjacency` (its band, degree and neighbour list);
    the weights and icm_iterations as the fit's config gives them.
    Returns (Hs_s (K, 3, 3), e_steps (K,) float32: each step's candidate
    energy, took (K,) bool: the steps taken), as
    `pipeline._f_fallback_plain` does. CUDA tensors only."""
    if not (torch.is_tensor(thr) and thr.numel() == 1):
        raise ValueError("thr: a one-element tensor on the card")
    k, n = r_c.shape
    l = k + 1
    Hs_c, r_c, Hs_prop, r_prop = (t.contiguous()
                                  for t in (Hs_c, r_c, Hs_prop, r_prop))
    valid, active = valid.contiguous(), active.contiguous()
    deg = adj.deg.contiguous()
    e_c, thr = e_c.reshape(1), thr.reshape(1)
    _build.require_cuda(Hs_c, r_c, Hs_prop, r_prop, valid, thr, active,
                        deg, e_c)
    _build.require_cuda(lab_c, dtype=torch.int64)
    _build.require_cuda(ok_prop, dtype=torch.bool)
    if (Hs_c.shape != (k, 3, 3) or Hs_prop.shape != (k, 3, 3)
            or r_prop.shape != (k, n) or ok_prop.shape != (k,)
            or active.shape != (k,) or lab_c.shape != (n,)
            or valid.shape != (n,) or deg.numel() != n):
        raise ValueError(f"Hs_c {tuple(Hs_c.shape)}, r_c {tuple(r_c.shape)},"
                         f" Hs_prop {tuple(Hs_prop.shape)}, r_prop "
                         f"{tuple(r_prop.shape)}, ok_prop "
                         f"{tuple(ok_prop.shape)}, lab_c "
                         f"{tuple(lab_c.shape)}, valid {tuple(valid.shape)}")
    mrf_kernel._check_band(adj.band, n, l)
    nbr = mrf_kernel._neighbours(adj.band, adj.nbr)
    dev = r_c.device
    f32 = dict(dtype=torch.float32, device=dev)
    hs_s = torch.empty((k, 3, 3), **f32)
    e_s = torch.empty((1,), **f32)
    dct = torch.empty((l, n), **f32)
    base = torch.empty((l, n), **f32)
    save = torch.empty((2, n), **f32)
    starts = torch.empty((2, n), dtype=torch.int32, device=dev)
    e_steps = torch.empty((k,), **f32)
    took = torch.empty((k,), dtype=torch.bool, device=dev)
    lib, stream = _build.load(), _build.stream_handle(r_c)

    def end(which: int, i: int, polished=None):
        """Launch the front (0) or the back (1) of step i; the back reads
        K5's `polished` labels."""
        _build.check(lib.multih_f_accept_step(
            which, i, int(i == 0), valid.data_ptr(), deg.data_ptr(),
            nbr.cols.data_ptr(), nbr.ws.data_ptr(), nbr.cnt.data_ptr(),
            nbr.cols.shape[1], active.data_ptr(), thr.data_ptr(),
            Hs_prop.data_ptr(), ok_prop.data_ptr(), r_prop.data_ptr(),
            r_c.data_ptr(), lab_c.data_ptr(), Hs_c.data_ptr(),
            e_c.data_ptr(),
            None if polished is None else polished.data_ptr(),
            hs_s.data_ptr(), e_s.data_ptr(), dct.data_ptr(),
            base.data_ptr(), save.data_ptr(), starts.data_ptr(),
            e_steps.data_ptr(), took.data_ptr(), k, n, float(spatial_weight),
            float(outlier_cost), float(label_cost), stream),
            "f_accept_fallback")
        f_accept_fallback.launches += 1

    for i in range(k):
        end(0, i)
        end(1, i, mrf_kernel.icm_fused(starts, base, adj.band,
                                       icm_iterations, spatial_weight,
                                       nbr=nbr))
    return hs_s, e_steps, took


# the ends' launches (two a step; K5's count on mrf_kernel.icm_fused)
f_accept_fallback.launches = 0
