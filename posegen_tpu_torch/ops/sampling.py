"""Ray sampling: stratified, importance (inverse-CDF), cylinder clipping
(port of posegen_tpu/ops/sampling.py).

Randomness comes from an explicit `torch.Generator`; every sampler also takes
`det_noise`, pre-drawn noise that overrides the generator, so parity runs
hand both frameworks the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def sample_from_lineseg(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    perturb: float = 0.0,
    lindisp: bool = False,
    generator: Optional[torch.Generator] = None,
    det_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Stratified samples on [near, far] (reference ray_utils.py:204-251).

    near/far: (N, 1). Returns z_vals (N, n_samples).
    det_noise: optional (N, n_samples) uniform noise overriding the generator.
    """
    t = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t

    if perturb > 0.0:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        if det_noise is not None:
            t_rand = det_noise
        else:
            if generator is None:
                raise ValueError("perturbed sampling needs a generator or det_noise")
            t_rand = torch.rand(z.shape, dtype=z.dtype, device=z.device,
                                generator=generator)
        z = lower + (upper - lower) * t_rand
    return z


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
    det_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-CDF sampling (reference ray_utils.py:157-201).

    bins (N, B) and weights (N, B-1) define B-1 intervals. Returns samples
    (N, n_samples), detached from the weights.
    """
    weights = weights.detach() + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (N, B)

    if det_noise is not None:
        u = det_noise
    elif det:
        u = torch.linspace(0.0, 1.0, n_samples, dtype=cdf.dtype, device=cdf.device)
        u = u.expand(*cdf.shape[:-1], n_samples)
    else:
        if generator is None:
            raise ValueError("random importance sampling needs a generator or det_noise")
        u = torch.rand((*cdf.shape[:-1], n_samples), dtype=cdf.dtype,
                       device=cdf.device, generator=generator)
    u = u.contiguous()

    # side='right': inds = #(cdf <= u) >= 1 since cdf[0] = 0 <= u; u past the
    # last cdf entry gives below = above = B-1 (denom 0 -> 1 below)
    B = cdf.shape[-1]
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    frac = (u - cdf_b) / denom
    return bins_b + frac * (bins_a - bins_b)


def isample_from_lineseg(
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    det: bool = False,
    is_only: bool = False,
    alpha_base: float = 0.01,
    generator: Optional[torch.Generator] = None,
    det_noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Importance samples merged (stably sorted) with the coarse z_vals
    (reference ray_utils.py:255-289).

    Returns (z_all (N, S+I) sorted, z_samples (N, I), sorted_idxs (N, S+I)).
    """
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    if is_only:
        # single-net: max-filtered weights + floor (reference :271-277)
        w_l, w_k, w_u = weights[..., :-2], weights[..., 1:-1], weights[..., 2:]
        dist_w = 0.5 * (torch.maximum(w_l, w_k) + torch.maximum(w_k, w_u)) + alpha_base
    else:
        dist_w = weights[..., 1:-1]

    z_samples = sample_pdf(z_mid, dist_w, n_importance, det=det,
                           generator=generator, det_noise=det_noise)
    z_cat = torch.cat([z_vals, z_samples], dim=-1)
    z_all, sorted_idxs = torch.sort(z_cat, dim=-1, stable=True)
    return z_all, z_samples, sorted_idxs


def get_near_far_in_cylinder(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    cyl: torch.Tensor,
    near=0.35,
    far=2.75,
    g_axes: Tuple[int, int] = (0, 2),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip ray [near, far] to the pose's bounding cylinder via 2-D ray/circle
    intersection on the ground plane (reference ray_utils.py:292-344).

    rays_o/rays_d: (N, 3); cyl: (N, 5) [cx, cz, r, top, bot].
    near/far may be floats or (N, 1) tensors. Rays that miss the circle get
    the mean near/far of the rays that hit it (the reference's NaN repair),
    or keep the originals when every ray misses.
    """
    shape = (*rays_o.shape[:-1], 1)
    # no host data reaches the card here (the render dispatches chunk after
    # chunk without a stream synchronisation): a float fills on the device
    # and the ground axes are picked by integer indices, where
    # torch.as_tensor of a float or a list index is a host tensor that is
    # copied to the card and waited for
    near, far = (torch.full(shape, float(v), dtype=rays_o.dtype, device=rays_o.device)
                 if isinstance(v, (int, float)) else v.to(rays_o.dtype).expand(shape)
                 for v in (near, far))

    def ground(x):
        return torch.stack([x[..., g_axes[0]], x[..., g_axes[1]]], dim=-1)

    r_near = ground(rays_o + rays_d * near)
    r_far = ground(rays_o + rays_d * far)

    radius = cyl[..., 2:3]
    center = cyl[..., :2]

    nc = center - r_near
    nf = r_far - r_near
    nf_norm = torch.linalg.norm(nf, dim=-1)
    scale = torch.linalg.norm(ground(rays_d), dim=-1, keepdim=True)

    cross = nc[..., 0] * nf[..., 1] - nc[..., 1] * nf[..., 0]
    dist = (torch.abs(cross) / nf_norm)[..., None]

    q_sq = radius**2 - dist**2
    hit = q_sq >= 0.0
    Q = torch.sqrt(torch.clamp(q_sq, min=0.0))
    K = ((nc * nf).sum(-1) / nf_norm)[..., None]
    inside = (Q >= K).to(rays_o.dtype)  # near point inside circle -> keep near

    new_near = near + (1.0 - inside) * (K - Q) / scale
    new_far = near + (K + Q) / scale

    # NaN-repair analog: rays that miss the cylinder get the mean of hits
    n_hit = torch.clamp(hit.sum(), min=1)
    mean_near = torch.where(hit, new_near, 0.0).sum() / n_hit
    mean_far = torch.where(hit, new_far, 0.0).sum() / n_hit
    any_hit = hit.any()
    new_near = torch.where(hit, new_near, torch.where(any_hit, mean_near, near))
    new_far = torch.where(hit, new_far, torch.where(any_hit, mean_far, far))
    return new_near, new_far
