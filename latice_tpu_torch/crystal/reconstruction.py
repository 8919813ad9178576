"""Parent-grain reconstruction: prior-phase orientations through an OR (the
port of ``latice_tpu/crystal/reconstruction.py``).

Martensitic/bainitic steels, Ti alloys and Zr alloys are measured in the
child phase (α martensite, α-Ti...) but the microstructure of interest is
the parent (γ austenite, β-Ti) that transformed away. Given the orientation
relationship (OR) of the transformation, each child orientation constrains
its parent to a finite variant set; neighboring children that share a
parent grain agree on exactly one candidate. This module rebuilds the
parent map from that agreement — the role of MTEX's ``calcParent``/parent
grain reconstruction, absent from the reference.

Math. With ``g`` mapping sample → crystal frames (the repo convention,
utils/polefigure.py), a transformation with OR rotation ``T`` (parent
crystal frame → child crystal frame) produces child orientations

    g_child = s_c ⊗ T ⊗ s_p ⊗ g_parent,   s_c ∈ S_child, s_p ∈ S_parent.

Inverting, the parent candidates of a measured child are

    g_parent ≅ T⁻¹ ⊗ s_c ⊗ g_child   (modulo S_parent),

at most |S_child| distinct modulo parent symmetry (24 for the cubic KS OR;
degenerate ORs like Bain collapse further — deduplicated numerically).

ORs ship as *parallelism conditions* — KS: (111)γ ∥ (011)α with
[1-10]γ ∥ [1-11]α, etc. — and the rotation is constructed from the implied
orthonormal triads, so the tables cannot drift from their definitions (the
tests pin the published misorientation angles: KS 42.85°, NW 45.99°,
Bain 45° ⟨100⟩).

Algorithm (grain-level, the standard shape):
1. candidates: one batched quaternion pass per map, no loops;
2. edge fits: for every adjacent grain pair, the minimum disorientation over
   candidate pairs (V × V·S max-|dot| contraction, one jitted matmul per
   fixed-size block — padded, never recompiled; reduced on device so only
   scalars cross the link);
3. parent grains = connected components of the sub-tolerance agreement
   graph (scipy, host — data-dependent pointer chasing);
4. hypothesis scoring per component: every member of a true parent has its
   true candidate AT the parent's class, so scoring each seed-candidate
   hypothesis by total member support picks the parent with ~|component|
   margin. Per-edge voting is strictly weaker — an edge between variants
   whose candidate fans share several classes at the noise floor (packet
   degeneracies) is a coin flip locally but is still resolved globally;
5. outlier peeling: members the winning hypothesis cannot explain within
   tolerance (e.g. the minority side of an accidental cross-parent merge —
   unrelated cubic KS fans coincide to ~3° surprisingly often) re-form
   their own components from their mutual agreement edges and are re-scored;
6. symmetry-aware quaternion mean per component, then one polish sweep:
   re-pick each child's variant as the candidate nearest its parent's mean,
   re-average.

A parent is only identifiable where its children span enough distinct
variants: a component whose members' candidate fans share more than one
common class (all one variant, or all inside one degenerate packet) is
intrinsically ambiguous; the returned ``fit_deg`` stays small there, but the
orientation is one consistent hypothesis, not ground truth — same contract
as MTEX's ``calcParent``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from latice_tpu_torch.crystal.csl import _host_symmetry, _qmul_np
from latice_tpu_torch.crystal.quaternion import from_euler_zxz_deg, quat_mul, to_euler_zxz_deg
from latice_tpu_torch.crystal.symmetry import nearest_symmetry_equivalent, symmetry_quats
from latice_tpu_torch.device import full_f32_matmul, resolve_device

__all__ = [
    "ORIENTATION_RELATIONSHIPS",
    "ParentReconstruction",
    "grain_adjacency",
    "or_rotation",
    "or_variant_table",
    "parent_candidates",
    "reconstruct_parents",
]

#: OR definitions as parallelism conditions:
#: ((plane_parent, plane_child), (direction_parent, direction_child)).
#: The direction must lie in the plane on both sides (checked at build).
ORIENTATION_RELATIONSHIPS: dict[str, tuple] = {
    # Kurdjumov–Sachs: {111}γ ∥ {011}α, ⟨1-10⟩γ ∥ ⟨1-11⟩α (fcc → bcc).
    "ks": (((1, 1, 1), (0, 1, 1)), ((1, -1, 0), (1, -1, 1))),
    # Nishiyama–Wassermann: {111}γ ∥ {011}α, ⟨1-21⟩... ⟨112⟩γ ∥ ⟨011⟩α.
    "nw": (((1, 1, 1), (0, 1, 1)), ((1, 1, -2), (0, 1, -1))),
    # Bain: {001}γ ∥ {001}α, ⟨110⟩γ ∥ ⟨100⟩α (the 45° ⟨100⟩ rotation).
    "bain": (((0, 0, 1), (0, 0, 1)), ((1, 1, 0), (1, 0, 0))),
    # Pitsch: {001}γ ∥ {-101}α, ⟨110⟩γ ∥ ⟨111⟩α.
    "pitsch": (((0, 0, 1), (-1, 0, 1)), ((1, 1, 0), (1, 1, 1))),
}


def _triad(n, d) -> np.ndarray:
    """Right-handed orthonormal triad [d̂, n̂×d̂, n̂] as matrix columns."""
    n = np.asarray(n, np.float64)
    d = np.asarray(d, np.float64)
    if abs(float(n @ d)) > 1e-12:
        raise ValueError(f"direction {d} does not lie in plane {n}")
    n = n / np.linalg.norm(n)
    d = d / np.linalg.norm(d)
    return np.stack([d, np.cross(n, d), n], axis=1)


def or_rotation(relationship) -> np.ndarray:
    """Unit quaternion ``T`` (parent crystal frame → child crystal frame).

    ``relationship``: an `ORIENTATION_RELATIONSHIPS` key, or a custom
    ``((plane_p, plane_c), (dir_p, dir_c))`` parallelism pair.
    """
    if isinstance(relationship, str):
        try:
            relationship = ORIENTATION_RELATIONSHIPS[relationship.lower()]
        except KeyError:
            raise ValueError(
                f"unknown OR {relationship!r}; known: "
                f"{', '.join(ORIENTATION_RELATIONSHIPS)} (or pass "
                "((plane_p, plane_c), (dir_p, dir_c)))"
            ) from None
    (np_, nc), (dp, dc) = relationship
    # T maps parent-frame coords to child-frame coords: T @ n_p = n_c etc.
    m = _triad(nc, dc) @ _triad(np_, dp).T
    # Matrix -> quaternion (scalar-first), Shepperd's stable branch choice.
    t = np.trace(m)
    if t > 0:
        w = 0.5 * np.sqrt(1.0 + t)
        x = (m[2, 1] - m[1, 2]) / (4 * w)
        y = (m[0, 2] - m[2, 0]) / (4 * w)
        z = (m[1, 0] - m[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        v = np.empty(3)
        v[i] = 0.5 * s
        v[j] = (m[j, i] + m[i, j]) / (2 * s)
        v[k] = (m[k, i] + m[i, k]) / (2 * s)
        w = (m[k, j] - m[j, k]) / (2 * s)
        x, y, z = v
    q = np.asarray([w, x, y, z], np.float64)
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def parent_candidates(
    child_euler_deg: np.ndarray,
    relationship="ks",
    parent_group: str = "432",
    child_group: str = "432",
    dedupe_tol_deg: float = 0.5,
    device=None,
) -> np.ndarray:
    """Parent-orientation candidates of each child orientation.

    Returns ``(N, V, 4)`` unit quaternions: for child ``i``, the V distinct
    (modulo parent symmetry) solutions of the OR inversion
    ``T⁻¹ ⊗ s_c ⊗ g_child``. V is determined numerically: symmetry-
    degenerate ORs (Bain: V=3 under cubic/cubic) collapse automatically.

    Args:
        child_euler_deg: ``(..., 3)`` zxz Euler degrees of child orientations
            (typically grain means, not raw pixels).
        relationship: OR name or parallelism pair (see `or_rotation`).
        parent_group / child_group: point groups of the two phases.
        dedupe_tol_deg: candidates closer than this (modulo parent symmetry)
            are one variant.
    """
    euler = np.asarray(child_euler_deg, np.float32).reshape(-1, 3)
    t_inv = or_rotation(relationship) * np.asarray([1.0, -1, -1, -1])
    s_child = _host_symmetry(child_group)  # (Sc, 4)
    # Variant generators: T⁻¹ ⊗ s_c, deduplicated modulo PARENT symmetry
    # (left-multiplying the candidate by s_p maps variants onto each other:
    # generators G1, G2 coincide iff G1 ⊗ G2⁻¹ ∈ S_parent).
    gens = _qmul_np(t_inv[None, :], s_child)  # (Sc, 4)
    s_parent = _host_symmetry(parent_group)
    keep: list[np.ndarray] = []
    cos_tol = np.cos(np.radians(dedupe_tol_deg) / 2.0)
    for g in gens:
        dup = False
        for k in keep:
            # distinct iff angle(s_p ⊗ k, g) > tol for every s_p
            imgs = _qmul_np(s_parent, k[None, :])
            if np.abs(imgs @ g).max() >= cos_tol:
                dup = True
                break
        if not dup:
            keep.append(g)
    gens = np.stack(keep)  # (V, 4)

    q_child = _euler_quats(euler, resolve_device(device))  # (N, 4)
    cands = _qmul_np(gens[None, :, :], q_child[:, None, :])  # (N, V, 4)
    flip = cands[..., :1] < 0
    cands = np.where(flip, -cands, cands)
    return (
        cands / np.linalg.norm(cands, axis=-1, keepdims=True)
    ).astype(np.float32)


def or_variant_table(
    relationship="ks",
    parent_group: str = "432",
    child_group: str = "432",
    dedupe_tol_deg: float = 0.5,
) -> np.ndarray:
    """The OR's physical variants as misorientation representatives.

    Returns ``(V, 4)`` unit quaternions ``T ⊗ s_p``: for a parent with
    orientation ``g_p``, variant ``k``'s child orientation is
    ``table[k] ⊗ g_p`` (modulo child symmetry). Deduplicated modulo LEFT
    child symmetry — two parent-side choices are one physical variant when
    ``T s_p1 = s_c T s_p2``. KS: 24, NW: 12, Bain: 3.
    """
    t = or_rotation(relationship)
    s_parent = _host_symmetry(parent_group)
    s_child = _host_symmetry(child_group)
    reps = _qmul_np(t[None, :], s_parent)  # (Sp, 4)
    keep: list[np.ndarray] = []
    cos_tol = np.cos(np.radians(dedupe_tol_deg) / 2.0)
    for r in reps:
        dup = False
        for k in keep:
            imgs = _qmul_np(s_child, k[None, :])
            if np.abs(imgs @ r).max() >= cos_tol:
                dup = True
                break
        if not dup:
            keep.append(r)
    out = np.stack(keep)
    flip = out[:, :1] < 0
    return np.where(flip, -out, out) / np.linalg.norm(out, axis=-1, keepdims=True)


def grain_adjacency(labels: np.ndarray) -> np.ndarray:
    """Unique adjacent grain-label pairs ``(E, 2)`` of a (H, W) label map."""
    lab = np.asarray(labels)
    pairs = np.concatenate(
        [
            np.stack([lab[:, :-1].ravel(), lab[:, 1:].ravel()], 1),
            np.stack([lab[:-1, :].ravel(), lab[1:, :].ravel()], 1),
        ]
    )
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    pairs = np.sort(pairs, axis=1)
    return np.unique(pairs, axis=0)


def _euler_quats(euler: np.ndarray, dev: torch.device) -> np.ndarray:
    """float32 zxz Euler degrees → float64 quaternions, converted in float32
    on ``dev`` as the JAX package converts them."""
    with torch.no_grad():
        q = from_euler_zxz_deg(torch.as_tensor(euler, dtype=torch.float32, device=dev))
    return q.cpu().numpy().astype(np.float64)


def _pair_dots(cand_a: torch.Tensor, cand_b: torch.Tensor, sym_parent: torch.Tensor) -> torch.Tensor:
    """Per pair, the (V, V) max-|dot| over parent-symmetry images:
    ``out[e, i, j] = max_s |⟨a_i, s ⊗ b_j⟩|``, cos(disorientation/2) between
    a's candidate i and b's candidate j modulo parent symmetry. ``cand_a``
    and ``cand_b`` are (E, V, 4), ``sym_parent`` (S, 4)."""
    imgs = quat_mul(sym_parent[None, None, :, :], cand_b[:, :, None, :])  # (E, V, S, 4)
    e, v, s, _ = imgs.shape
    with full_f32_matmul():
        dots = torch.bmm(cand_a, imgs.reshape(e, v * s, 4).transpose(1, 2)).abs_()
    return dots.view(e, v, v, s).amax(dim=-1)


def _deg(dots: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.rad2deg(torch.arccos(torch.clamp(dots, 0.0, 1.0)))


def _edge_min_fits(cand_a, cand_b, sym_parent) -> torch.Tensor:
    """Per edge: the least disorientation (deg) over all candidate pairs,
    reduced on the device so only (E,) comes back, not (E, V, V)."""
    return _deg(_pair_dots(cand_a, cand_b, sym_parent).amax(dim=(1, 2)))


def _hypothesis_fits(cand_seed, cand, sym_parent) -> tuple[torch.Tensor, torch.Tensor]:
    """Per grain and seed-candidate hypothesis h: the best fit among the
    grain's candidates, as (fit_deg (G, V), argmin index (G, V))."""
    best, idx = _pair_dots(cand_seed, cand, sym_parent).max(dim=-1)
    return _deg(best), idx


def _nearest_candidate(cands: torch.Tensor, ref: torch.Tensor, sym_parent: torch.Tensor) -> torch.Tensor:
    """Index of each grain's candidate (G, V, 4) nearest ``ref`` (G, 4)
    modulo parent symmetry."""
    imgs = quat_mul(sym_parent[None, :, :], ref[:, None, :])  # (G, S, 4)
    with full_f32_matmul():
        dots = torch.bmm(cands, imgs.transpose(1, 2)).abs_().amax(dim=-1)  # (G, V)
    return dots.argmax(dim=-1)


#: Pairs per device block: bounds the (BLOCK, V, V·S) intermediate, 0.45 GB
#: for the cubic KS OR. The JAX package pads the last block to this size so
#: XLA compiles once; torch needs no padding.
_EDGE_BLOCK = 8192


@torch.no_grad()
def _blocked(fn, a: np.ndarray, b: np.ndarray, sym: torch.Tensor):
    """Run a pair function over blocks of `_EDGE_BLOCK` pairs on ``sym``'s
    device; the results, concatenated, on the host."""
    outs = []
    for lo in range(0, len(a), _EDGE_BLOCK):
        ca, cb = (torch.as_tensor(x[lo:lo + _EDGE_BLOCK], device=sym.device) for x in (a, b))
        res = fn(ca, cb, sym)
        outs.append(tuple(r.cpu().numpy() for r in res) if isinstance(res, tuple)
                    else res.cpu().numpy())
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate(parts) for parts in zip(*outs))
    return np.concatenate(outs)


class ParentReconstruction(NamedTuple):
    """Result of `reconstruct_parents` (host arrays, grain-indexed)."""

    #: Parent-grain id per child grain (0..n_parents-1; grains whose every
    #: edge failed the tolerance become single-child parents).
    parent_labels: np.ndarray
    #: Number of reconstructed parent grains.
    n_parents: int
    #: zxz Euler degrees of each parent grain ``(n_parents, 3)``.
    parent_orientation: np.ndarray
    #: Physical variant id per child grain: which of `or_variant_table`'s V
    #: variants relates the child to its parent's mean orientation (MTEX's
    #: ``variantId``). Consistent within a parent grain — same-variant
    #: laths/blocks share an id — but numbered relative to the parent's
    #: (gauge-dependent) representative, so ids permute between parents.
    variant: np.ndarray
    #: Disorientation (degrees) of each child grain's chosen candidate to
    #: its parent's mean orientation — the reconstruction residual.
    fit_deg: np.ndarray


def _parent_mean(
    chosen: np.ndarray,  # (G, 4) each child's chosen candidate
    ref: np.ndarray,  # (G, 4) alignment reference per child
    parent_labels: np.ndarray,
    n_parents: int,
    sym_parent,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-component quaternion mean of ``chosen`` (modulo parent symmetry).

    Each chosen candidate is mapped to its symmetry image nearest ``ref``
    (then hemisphere-aligned), and the component mean is the dominant
    eigenvector of the summed outer products — `quaternion.quat_mean`
    semantics, scattered by component. Returns (means (P, 4), per-child
    residual fit in degrees (G,)).
    """
    with torch.no_grad():
        # compose="sample" (premultiply): parent candidates are ambiguous as
        # s_p ⊗ cand in this module's sample→crystal convention, the side
        # `parent_candidates` dedups and `_pair_dots` enumerates.
        aligned = nearest_symmetry_equivalent(
            torch.as_tensor(ref, dtype=torch.float32, device=sym_parent.device),
            torch.as_tensor(chosen, dtype=torch.float32, device=sym_parent.device),
            sym_parent,
            compose="sample",
        ).cpu().numpy().astype(np.float64)
    sign = np.where((aligned * ref).sum(-1) < 0, -1.0, 1.0)
    aligned *= sign[:, None]
    m = np.zeros((n_parents, 4, 4), np.float64)
    np.add.at(m, parent_labels, aligned[:, :, None] * aligned[:, None, :])
    _, vecs = np.linalg.eigh(m)
    parent_q = vecs[..., -1]
    dots = np.abs((aligned * parent_q[parent_labels]).sum(-1))
    fit = 2.0 * np.degrees(np.arccos(np.clip(dots, -1.0, 1.0)))
    return parent_q, fit.astype(np.float32)


def reconstruct_parents(
    child_euler_deg: np.ndarray,
    adjacency: np.ndarray,
    relationship="ks",
    parent_group: str = "432",
    child_group: str = "432",
    tolerance_deg: float = 2.5,
    device=None,
) -> ParentReconstruction:
    """Rebuild parent grains from child-grain mean orientations.

    Args:
        child_euler_deg: ``(G, 3)`` zxz Euler degrees — child grain means
            (`crystal.grain_statistics`).
        adjacency: ``(E, 2)`` adjacent grain-id pairs (`grain_adjacency`).
        relationship: OR name or parallelism pair.
        parent_group / child_group: phase point groups.
        tolerance_deg: two neighboring children agree on a parent when some
            candidate pair matches within this disorientation. Keep tight:
            unrelated cubic KS candidate fans coincide to ~3° surprisingly
            often (24×24 pairs × 24 symmetry images per edge), so the 2.5°
            default — MTEX's — is a meaningful ceiling, not a starting point.

    Returns:
        ParentReconstruction. Parent ids are in child-grain first-visit
        order, so they are deterministic.
    """
    euler = np.asarray(child_euler_deg, np.float32).reshape(-1, 3)
    g = len(euler)
    adjacency = np.asarray(adjacency, np.int64).reshape(-1, 2)
    if adjacency.size and adjacency.max() >= g:
        raise ValueError(
            f"adjacency references grain {adjacency.max()} but only "
            f"{g} orientations given"
        )
    dev = resolve_device(device)
    cands = parent_candidates(
        euler, relationship, parent_group, child_group, device=dev
    )  # (G, V, 4)
    v = cands.shape[1]
    sym_p = symmetry_quats(parent_group, device=dev)

    # Agreement graph: edges whose best candidate pair is sub-tolerance.
    edge_fit = (
        _blocked(_edge_min_fits, cands[adjacency[:, 0]], cands[adjacency[:, 1]], sym_p)
        if len(adjacency)
        else np.zeros(0, np.float32)
    )
    ok = edge_fit <= tolerance_deg

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    graph = coo_matrix(
        (np.ones(int(ok.sum()), np.int8), (adjacency[ok, 0], adjacency[ok, 1])),
        shape=(g, g),
    )
    _, raw = connected_components(graph, directed=False)

    # Hypothesis scoring with outlier peeling. Every member of a true parent
    # has its true candidate AT the parent's class, so the right hypothesis
    # collects ~|component| support while any wrong class collects ~1 plus
    # coincidences — far stronger than per-edge votes, which have only
    # edge-level margins and are defeated by packet degeneracies (variant
    # pairs sharing several classes at the noise floor). Members the winning
    # hypothesis cannot explain (fit > tolerance — e.g. the minority side of
    # an accidental cross-parent merge) are peeled off and re-form their own
    # components from their mutual agreement edges; seeds are explained by
    # construction, so the unexplained set strictly shrinks and the loop
    # terminates.
    labels = raw.astype(np.int64)
    variant = np.zeros(g, np.int32)
    hyp_ref = np.zeros((g, 4), np.float64)  # each child's hypothesis quat
    active = np.ones(g, bool)  # members still being (re)assigned
    while True:
        n_comp = int(labels.max()) + 1 if g else 0
        seeds = np.full(n_comp, -1, np.int64)
        for i in range(g):  # first member in grain order = the seed
            if seeds[labels[i]] < 0:
                seeds[labels[i]] = i
        fit_h, arg_h = _blocked(
            _hypothesis_fits, cands[seeds[labels]], cands, sym_p
        )  # (G, V) each
        support = np.maximum(0.0, 1.0 - fit_h / tolerance_deg) ** 2
        score = np.zeros((n_comp, v))
        np.add.at(score, labels[active], support[active])
        hstar = score.argmax(axis=1)  # (n_comp,)
        idx = np.arange(g)
        variant[active] = arg_h[idx, hstar[labels]][active]
        hyp_ref[active] = cands[seeds[labels], hstar[labels]][active]
        unexplained = active & (fit_h[idx, hstar[labels]] > tolerance_deg)
        if not unexplained.any():
            break
        # Re-form components among the unexplained from their mutual edges.
        both = unexplained[adjacency[:, 0]] & unexplained[adjacency[:, 1]] & ok
        sub = coo_matrix(
            (
                np.ones(int(both.sum()), np.int8),
                (adjacency[both, 0], adjacency[both, 1]),
            ),
            shape=(g, g),
        )
        _, sub_raw = connected_components(sub, directed=False)
        labels = labels.copy()
        labels[unexplained] = int(labels.max()) + 1 + sub_raw[unexplained]
        _, labels = np.unique(labels, return_inverse=True)
        active = unexplained

    # Deterministic parent ids: first-visit order over child grains.
    _, first = np.unique(labels, return_index=True)
    order = np.argsort(np.argsort(first))
    parent_labels = order[labels].astype(np.int32)
    n_parents = int(parent_labels.max()) + 1 if g else 0

    # Component means of the assigned candidates, then one polish sweep:
    # re-pick each child's variant as the candidate nearest its parent's
    # mean (the hypothesis quat is a single noisy member), re-average.
    chosen = cands[np.arange(g), variant]
    parent_q, _ = _parent_mean(chosen, hyp_ref, parent_labels, n_parents, sym_p)
    with torch.no_grad():
        variant = _nearest_candidate(
            torch.as_tensor(cands, device=dev),
            torch.as_tensor(parent_q[parent_labels], dtype=torch.float32, device=dev),
            sym_p,
        ).cpu().numpy().astype(np.int32)
    chosen = cands[np.arange(g), variant]
    parent_q, fit_out = _parent_mean(
        chosen, parent_q[parent_labels], parent_labels, n_parents, sym_p
    )

    # Physical variant ids: classify each child's misorientation to its
    # parent mean, m = g_child ⊗ g_parent⁻¹, against the OR variant table
    # (modulo left child symmetry) — MTEX's variantId semantics.
    vreps = or_variant_table(relationship, parent_group, child_group)
    s_child = _host_symmetry(child_group)
    child_q = _euler_quats(euler, dev)
    p_conj = parent_q[parent_labels] * np.asarray([1.0, -1, -1, -1])
    m = _qmul_np(child_q, p_conj)  # (G, 4)
    imgs = _qmul_np(s_child[:, None, :], vreps[None, :, :])  # (S, Vp, 4)
    dots = np.abs(
        np.einsum("gq,svq->gsv", m, imgs)
    ).max(axis=1)  # (G, Vp)
    variant_id = dots.argmax(axis=1).astype(np.int32)

    with torch.no_grad():
        parent_euler = to_euler_zxz_deg(
            torch.as_tensor(parent_q, dtype=torch.float32, device=dev)
        ).cpu().numpy().astype(np.float32)
    return ParentReconstruction(
        parent_labels=parent_labels,
        n_parents=int(n_parents),
        parent_orientation=parent_euler,
        variant=variant_id,
        fit_deg=fit_out,
    )
