"""The pattern dictionary of the DI cells, drawn from ``--seed`` on the device.

A dictionary for dictionary indexing samples orientation space and holds
one simulated pattern per orientation. EMsoft's EMDI samples the
cubochoric grid and renders dynamical master patterns; here (see
``reference/ncc.py`` for each departure) the orientations are a uniform
random draw over SO(3), each reduced to the fundamental zone of its point
group, and the patterns are `gen.render`'s Kikuchi band model without its
background shift and counting noise: the ideal pattern, rounded to uint8.
"""

from __future__ import annotations

import torch

from port_bench import gen
from port_bench.reference import rotations as rot

__all__ = ["DICTIONARY_DI", "dictionary", "reduce_to_zone", "render_clean"]

# A stream of its own (`gen`'s streams are 0-3), so that the dictionary
# never shifts the scan's or the sample's draws.
DICTIONARY_DI = 16


def reduce_to_zone(q: torch.Tensor, group: str) -> torch.Tensor:
    """Each unit quaternion as the equivalent ``q ⊗ s`` (``s`` of the
    point group) of largest scalar part, scalar first and non-negative.
    ``q ⊗ s`` permutes the crystal's plane normals, so the rendered pattern
    does not change."""
    sym = torch.as_tensor(rot.point_group(group), dtype=q.dtype, device=q.device)
    images = gen._qmul(q[:, None, :].expand(-1, len(sym), -1), sym[None].expand(len(q), -1, -1))
    best = images[..., 0].abs().argmax(dim=1)
    out = images[torch.arange(len(q), device=q.device), best]
    return torch.where(out[:, :1] < 0, -out, out)


def render_clean(quats: torch.Tensor, phase: torch.Tensor, groups: list[str], traffic: dict,
                 out: torch.Tensor) -> None:
    """`gen.render`'s bands over its background, with no shift and no
    counting noise: ``round(counts * (background + contrast * bands))``
    clipped to uint8, into ``out`` ``(n, S, S)``, in chunks of
    ``dictionary_chunk`` on ``quats``' device."""
    device = quats.device
    s = traffic["image_size"]
    c = (torch.arange(s, device=device, dtype=torch.float32) + 0.5) / s - 0.5
    yy, xx = torch.meshgrid(-c, c, indexing="ij")
    dirs = torch.stack([xx, yy, torch.full_like(xx, traffic["detector_distance"])], -1).reshape(-1, 3)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    fams = [gen._families(g) for g in groups]
    k_max = max(len(f[0]) for f in fams)
    normals = torch.zeros(len(fams), k_max, 3, device=device)
    amp = torch.zeros(len(fams), k_max, device=device)
    inv_w = torch.ones(len(fams), k_max, device=device)
    for i, (n, a, w) in enumerate(fams):
        normals[i, : len(n)] = torch.as_tensor(n, dtype=torch.float32, device=device)
        amp[i, : len(n)] = torch.as_tensor(a, dtype=torch.float32, device=device)
        inv_w[i, : len(n)] = torch.as_tensor(1.0 / w, dtype=torch.float32, device=device)
    r2 = (xx.reshape(-1) ** 2 + yy.reshape(-1) ** 2)[None]
    bg = 0.3 + 0.5 * torch.exp(-r2 / 0.25)
    chunk = traffic["dictionary_chunk"]
    for i in range(0, len(quats), chunk):
        q = quats[i : i + chunk]
        ph = phase[i : i + chunk].long()
        n_s = torch.einsum("bij,bkj->bki", gen._matrix(q).float(), normals[ph])
        dots = torch.einsum("pj,bkj->bpk", dirs, n_s) * inv_w[ph][:, None, :]
        bands = (torch.exp(-dots * dots) * amp[ph][:, None, :]).sum(-1)
        lam = traffic["counts"] * (bg + traffic["band_contrast"] * bands)
        out[i : i + len(q)].copy_(torch.round(lam).clamp_(0.0, 255.0).to(torch.uint8).view(-1, s, s))


def dictionary(cfg: dict, traffic: dict, device, seed: int):
    """``(patterns (N, S, S) uint8 on device, euler (N, 3) f64 degrees on
    the host, phases (N,) int32)``: ``dictionary_rows`` orientations per
    phase of ``cfg``, drawn uniformly and reduced to the phase's zone, and
    their clean patterns."""
    g = gen.generator(device, seed, DICTIONARY_DI)
    n, s = cfg["dictionary_rows"], traffic["image_size"]
    quats, phases = [], []
    for p, group in enumerate(cfg["phases"]):
        quats.append(reduce_to_zone(gen.random_quats(n, g, device), group))
        phases.append(torch.full((n,), p, dtype=torch.int32, device=device))
    q, ph = torch.cat(quats), torch.cat(phases)
    out = torch.empty(len(q), s, s, dtype=torch.uint8, device=device)
    render_clean(q, ph, cfg["phases"], traffic, out)
    return out, gen.quat_to_euler_zxz_deg(q).cpu().numpy(), ph.cpu().numpy()
