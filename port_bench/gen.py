"""Seeded inputs, made with the benchmark's own generator in plain torch.

Everything here is drawn from ``--seed`` on the device it is given, in a few
large calls: the weights (`weights`), the latent dictionary (`dictionary`),
kinematic-like EBSD patterns (`render`) laid out as a grain map (`scan`). The
same seed gives the same arrays; nothing calls the program's simulator.

A pattern is the gnomonic projection onto a 128x128 detector of Kikuchi
bands, one Gaussian profile per lattice plane of a few low-index families,
rotated by the pattern's orientation, over a smooth background, with
Poisson counting noise, clipped to uint8.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

__all__ = [
    "dictionary",
    "generator",
    "quat_to_euler_zxz_deg",
    "random_quats",
    "render",
    "scan",
    "weights",
]


def generator(device, seed: int, stream: int) -> torch.Generator:
    """An independent stream per ``(seed, stream)``; any size of seed."""
    word = np.random.SeedSequence([int(seed) & (2**64 - 1), int(stream)]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(word[0]) & (2**63 - 1))


# Streams, so that a new input never shifts the draws of another.
WEIGHTS, DICTIONARY, SCAN, SAMPLE = range(4)


def weights(layout, device, seed: int) -> dict[str, torch.Tensor]:
    """float32 parameters, each uniform in ``±1/sqrt(fan_in)``, from one
    draw on ``device``; ``layout`` is `reference.vae.param_layout`."""
    sizes = [math.prod(shape) for _, shape, _ in layout]
    flat = torch.rand(sum(sizes), generator=generator(device, seed, WEIGHTS), device=device)
    out = {}
    for (name, shape, fan_in), part in zip(layout, torch.split(flat, sizes)):
        out[name] = ((part * 2.0 - 1.0) * fan_in**-0.5).view(shape)
    return out


def random_quats(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """``(n, 4)`` uniform random unit quaternions, scalar first, w >= 0."""
    q = torch.randn(n, 4, generator=gen, device=device, dtype=torch.float64)
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[:, :1] < 0, -q, q)


def _small_rotations(n: int, max_deg: float, gen, device) -> torch.Tensor:
    axis = torch.randn(n, 3, generator=gen, device=device, dtype=torch.float64)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = torch.rand(n, generator=gen, device=device, dtype=torch.float64) * math.radians(max_deg) / 2
    return torch.cat([torch.cos(half)[:, None], axis * torch.sin(half)[:, None]], dim=-1)


def _qmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def quat_to_euler_zxz_deg(q: torch.Tensor) -> torch.Tensor:
    """Extrinsic zxz Euler degrees (``R = Rz(a3) Rx(a2) Rz(a1)``) of unit
    quaternions; the measure-zero gimbal lock is not treated."""
    m = _matrix(q)
    a1 = torch.atan2(m[..., 2, 0], m[..., 2, 1])
    a2 = torch.atan2(torch.sqrt(m[..., 2, 0] ** 2 + m[..., 2, 1] ** 2), m[..., 2, 2])
    a3 = torch.atan2(m[..., 0, 2], -m[..., 1, 2])
    return torch.rad2deg(torch.stack([a1, a2, a3], dim=-1))


def dictionary(cfg: dict, device, seed: int):
    """The latent dictionary of ``cfg``: per phase, ``rows_per_phase`` unit
    vectors in clusters of ``cluster_rows`` (a random centre and members
    ``cluster_spread`` away in each coordinate) whose orientations lie
    within ``cluster_degrees`` of the cluster's own. Near-duplicate entries
    are what an orientation grid gives a dictionary; they let the consensus
    succeed. Returns host ``(vectors (N, D) f32, euler (N, 3) f64 degrees,
    phases (N,) int32)``."""
    gen = generator(device, seed, DICTIONARY)
    d, m = cfg["latent_dim"], cfg["cluster_rows"]
    vecs, eulers, phases = [], [], []
    for phase, _ in enumerate(cfg["phases"]):
        n = cfg["rows_per_phase"]
        groups = -(-n // m)
        centres = torch.randn(groups, d, generator=gen, device=device)
        centres = centres / torch.linalg.vector_norm(centres, dim=-1, keepdim=True)
        v = centres.repeat_interleave(m, 0)[:n]
        v = v + cfg["cluster_spread"] * torch.randn(n, d, generator=gen, device=device)
        vecs.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
        q = random_quats(groups, gen, device).repeat_interleave(m, 0)[:n]
        q = _qmul(q, _small_rotations(n, cfg["cluster_degrees"], gen, device))
        eulers.append(quat_to_euler_zxz_deg(q))
        phases.append(torch.full((n,), phase, dtype=torch.int32))
    return (torch.cat(vecs).cpu().numpy(), torch.cat(eulers).cpu().numpy(),
            torch.cat(phases).numpy())


def _families(group: str):
    """``(normals (K, 3), amplitude (K,), width (K,))`` of a few low-index
    plane families in the crystal frame; a band is symmetric in the sign of
    its normal, so each plane appears once."""
    fams = []
    if group == "432":
        def family(hkl):
            out = set()
            for p in itertools.permutations(hkl):
                for s in itertools.product((1, -1), repeat=3):
                    v = tuple(a * b for a, b in zip(p, s))
                    if v != (0, 0, 0) and tuple(-x for x in v) not in out:
                        out.add(v)
            return sorted(out)

        for hkl, amp, width in (((1, 1, 1), 1.0, 0.030), ((2, 0, 0), 0.7, 0.035),
                                ((2, 2, 0), 0.5, 0.025), ((3, 1, 1), 0.3, 0.015)):
            fams.append((family(hkl), amp, width))
    elif group == "622":
        az = np.deg2rad(np.arange(6) * 60.0)
        fams.append(([(0.0, 0.0, 1.0)], 1.0, 0.030))
        fams.append(([(math.cos(a), math.sin(a), 0.0) for a in az[:3]], 0.7, 0.030))
        fams.append(([(math.cos(a + math.pi / 6), math.sin(a + math.pi / 6), 0.0) for a in az[:3]],
                     0.5, 0.020))
        t = math.radians(61.0)
        fams.append(([(math.sin(t) * math.cos(a), math.sin(t) * math.sin(a), math.cos(t)) for a in az],
                     0.4, 0.020))
    else:
        raise ValueError(f"no plane families for point group {group!r}")
    normals, amp, width = [], [], []
    for planes, a, w in fams:
        for v in planes:
            v = np.asarray(v, np.float64)
            normals.append(v / np.linalg.norm(v))
            amp.append(a)
            width.append(w)
    return np.stack(normals), np.asarray(amp), np.asarray(width)


def render(quats: torch.Tensor, phase: torch.Tensor, groups: list[str], traffic: dict,
           gen: torch.Generator, out: torch.Tensor) -> None:
    """Render one uint8 pattern per orientation into ``out`` ``(n, S, S)``
    (any device); the work runs on ``quats``' device in chunks."""
    device = quats.device
    s = traffic["image_size"]
    c = (torch.arange(s, device=device, dtype=torch.float32) + 0.5) / s - 0.5
    yy, xx = torch.meshgrid(-c, c, indexing="ij")
    dd = traffic["detector_distance"]
    dirs = torch.stack([xx, yy, torch.full_like(xx, dd)], -1).reshape(-1, 3)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    fams = [_families(g) for g in groups]
    k_max = max(len(f[0]) for f in fams)
    normals = torch.zeros(len(fams), k_max, 3, device=device)
    amp = torch.zeros(len(fams), k_max, device=device)
    inv_w = torch.ones(len(fams), k_max, device=device)
    for i, (n, a, w) in enumerate(fams):
        normals[i, : len(n)] = torch.as_tensor(n, dtype=torch.float32, device=device)
        amp[i, : len(n)] = torch.as_tensor(a, dtype=torch.float32, device=device)
        inv_w[i, : len(n)] = torch.as_tensor(1.0 / w, dtype=torch.float32, device=device)
    xs, ys = xx.reshape(-1), yy.reshape(-1)
    chunk = traffic["render_chunk"]
    for i in range(0, len(quats), chunk):
        q = quats[i : i + chunk]
        ph = phase[i : i + chunk].long()
        rot = _matrix(q).float()  # crystal -> sample
        n_s = torch.einsum("bij,bkj->bki", rot, normals[ph])
        dots = torch.einsum("pj,bkj->bpk", dirs, n_s) * inv_w[ph][:, None, :]
        bands = (torch.exp(-dots * dots) * amp[ph][:, None, :]).sum(-1)
        shift = (torch.rand(len(q), 2, generator=gen, device=device) - 0.5) * 0.1
        r2 = (xs[None] - shift[:, :1]) ** 2 + (ys[None] - shift[:, 1:]) ** 2
        bg = 0.3 + 0.5 * torch.exp(-r2 / 0.25)
        lam = traffic["counts"] * (bg + traffic["band_contrast"] * bands)
        counts = torch.poisson(lam, generator=gen).clamp_(max=255.0)
        out[i : i + len(q)].copy_(counts.to(torch.uint8).view(-1, s, s))


def scan(cfg: dict, traffic: dict, device, seed: int):
    """A ``rows x cols`` grain map and its patterns: host uint8 ``(R*C, S,
    S)``. Grains are the Voronoi cells of ``grains`` seeds, each of one
    random orientation and phase, with up to ``grain_spread_degrees`` of
    orientation scatter per pixel."""
    gen = generator(device, seed, SCAN)
    r, c = traffic["scan_rows"], traffic["scan_cols"]
    g = traffic["grains"]
    centres = torch.rand(g, 2, generator=gen, device=device) * torch.tensor([r, c], device=device)
    grid = torch.stack(torch.meshgrid(torch.arange(r, device=device), torch.arange(c, device=device),
                                      indexing="ij"), -1).reshape(-1, 2).float()
    grain = torch.cdist(grid, centres).argmin(-1)
    q = random_quats(g, gen, device)[grain]
    q = _qmul(q, _small_rotations(len(q), traffic["grain_spread_degrees"], gen, device))
    phase = torch.randint(len(cfg["phases"]), (g,), generator=gen, device=device)[grain]
    s = traffic["image_size"]
    out = torch.empty(r * c, s, s, dtype=torch.uint8)
    staged = torch.empty(traffic["render_chunk"], s, s, dtype=torch.uint8, device=device)
    for i in range(0, r * c, len(staged)):
        n = min(len(staged), r * c - i)
        render(q[i : i + n], phase[i : i + n], cfg["phases"], traffic, gen, staged[:n])
        out[i : i + n].copy_(staged[:n])
    return out.numpy()
