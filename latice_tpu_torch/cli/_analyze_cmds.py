"""``python -m latice_tpu_torch.cli.index analyze``: orientation-map
analysis, the port of ``latice_tpu/cli/_analyze_cmds.py``. The same flags,
defaults, output files, summary keys and errors, plus ``--device``; the
fields run on the device (``cuda`` unless ``--device`` says otherwise), the
labelling, statistics and figures on the host."""

from __future__ import annotations

import json
import logging

import numpy as np

logger = logging.getLogger(__name__)


def cmd_analyze(args) -> None:
    """Grain analysis of an indexed orientation map (crystal.maps)."""
    from latice_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    from latice_tpu_torch.crystal import (
        grain_boundary_mask,
        kernel_average_misorientation,
        label_grains,
        misorientation_maps,
    )

    vendor_phase = None
    vendor_bad = None
    low = args.orientations.lower()
    if low.endswith((".ang", ".ctf")):
        # Vendor result files (TSL/OIM .ang, Channel .ctf) analyze directly
        # — the practitioner's existing maps need no npy conversion. Grid
        # and per-pixel phases come from the file itself.
        from latice_tpu_torch.data import read_ang, read_ctf

        vmap = (read_ang if low.endswith(".ang") else read_ctf)(
            args.orientations
        )
        if args.grid is None:
            if vmap.grid is None:
                raise SystemExit(
                    f"{args.orientations} has no grid header — pass --grid"
                )
            args.grid = list(vmap.grid)
            logger.info(
                f"scan grid {vmap.grid[0]}x{vmap.grid[1]} from the file header"
            )
        orients = vmap.eulers
        vendor_bad = ~vmap.success
        # Unindexed pixels keep their vendor -1 phase id: the multiphase
        # segmentation isolates every edge touching one, so a contiguous
        # unindexed blob (vendor files write constant junk Eulers there)
        # can never fuse into a pseudo-grain.
        if vmap.phase.max() > 0 and args.phases is None:
            vendor_phase = vmap.phase
            # Downstream multi-phase branches key off args.phases; mark it
            # so they engage (the actual ids come from vendor_phase).
            args.phases = f"<phases embedded in {args.orientations}>"
    elif args.grid is None:
        raise SystemExit("--grid ROWS COLS is required for .npy maps")
    else:
        orients = np.load(args.orientations)
    rows, cols = args.grid
    if orients.ndim == 2:
        if rows * cols != len(orients):
            raise SystemExit(
                f"--grid {rows}x{cols} does not hold {len(orients)} points"
            )
        orients = orients.reshape(rows, cols, 3)
    multiphase = bool(args.phases) or vendor_phase is not None
    if multiphase:
        # Multi-phase map (query's <out>_phase.npy): per-phase symmetry,
        # phase boundaries always segment as grain boundaries.
        phases = (
            vendor_phase
            if vendor_phase is not None
            else np.load(args.phases)
        ).reshape(rows, cols)
        groups = (args.phase_groups or args.group).split(",")
        n_phases = int(phases.max()) + 1 if phases.size else 1
        if len(groups) < n_phases:
            raise SystemExit(
                f"{n_phases} phase ids in {args.phases} but only "
                f"{len(groups)} point groups — pass --phase-groups with one "
                "group per phase"
            )
    cleaned_summary = {}
    if args.clean is not None:
        # OIM-style cleanup before any analysis: fill unindexed pixels
        # (vendor success mask) and dissolve grains under --clean pixels.
        from latice_tpu_torch.crystal import clean_orientation_map

        bad0 = (
            vendor_bad.reshape(rows, cols) if vendor_bad is not None else None
        )
        orients, filled, cleaned_ph = clean_orientation_map(
            orients,
            bad=bad0,
            min_grain_px=args.clean,
            group=args.group,
            threshold_deg=args.gb_threshold,
            phases=phases if multiphase else None,
            groups=groups if multiphase else None,
            device=dev,
        )
        if multiphase:
            phases = cleaned_ph
        np.save(f"{args.out_prefix}_cleaned.npy", orients.reshape(-1, 3))
        cleaned_summary = {
            "cleaned_px": int(filled.sum()),
            "cleaned_out": f"{args.out_prefix}_cleaned.npy",
        }
        logger.info(f"cleanup replaced {filled.sum()} pixels")
    if multiphase:
        from latice_tpu_torch.crystal import misorientation_maps_multiphase

        maps = misorientation_maps_multiphase(orients, phases, groups, device=dev)
    elif (
        vendor_bad is not None
        and args.clean is None
        and vendor_bad.any()
    ):
        # Single-phase vendor file with unindexed pixels and no --clean:
        # isolate them through the negative-id convention (their constant
        # junk Eulers would otherwise fuse into pseudo-grains).
        from latice_tpu_torch.crystal import misorientation_maps_multiphase

        ph0 = np.where(vendor_bad.reshape(rows, cols), -1, 0)
        maps = misorientation_maps_multiphase(orients, ph0, [args.group], device=dev)
    else:
        maps = misorientation_maps(orients, group=args.group, device=dev)
    labels, n_grains = label_grains(maps, threshold_deg=args.gb_threshold)
    kam = kernel_average_misorientation(maps, threshold_deg=args.gb_threshold)
    boundaries = grain_boundary_mask(maps, threshold_deg=args.gb_threshold)

    prefix = args.out_prefix
    np.save(f"{prefix}_grains.npy", labels)
    np.save(f"{prefix}_kam.npy", kam)
    np.save(f"{prefix}_boundaries.npy", boundaries)
    summary = {
        "n_grains": int(n_grains),
        "mean_grain_px": float(labels.size / max(n_grains, 1)),
        "boundary_fraction": float(boundaries.mean()),
        "mean_kam_deg": float(kam.mean()),
        "outputs": [f"{prefix}_{s}.npy" for s in ("grains", "kam", "boundaries")],
        **cleaned_summary,
    }
    if args.grain_stats:
        # Per-grain summary: sizes, ECD, symmetry-aware mean orientation,
        # GOS. On multi-phase maps each grain lies in one phase (phase
        # boundaries always segment), so stats run once per distinct point
        # group and rows are taken from the grain's own phase.
        from latice_tpu_torch.crystal import grain_statistics

        flat_labels = labels.reshape(-1)
        flat_e = orients.reshape(-1, 3)
        _, seed_idx = np.unique(flat_labels, return_index=True)
        if args.phases:
            grain_phase = phases.reshape(-1)[seed_idx]
            grain_group = np.asarray(groups)[np.maximum(grain_phase, 0)]
        else:
            grain_phase = None
            grain_group = np.full(n_grains, args.group)
        sizes = np.zeros(n_grains, np.int64)
        ecd = np.zeros(n_grains, np.float32)
        mean_ori = np.zeros((n_grains, 3), np.float32)
        gos = np.zeros(n_grains, np.float32)
        # One grain_statistics pass per distinct point group, each over
        # only that group's grains (not the full map per group). Labels
        # compact to 0..k-1 monotonically, and the subset keeps every pixel
        # of a selected grain, so the seed-pixel (global first occurrence)
        # convention survives intact.
        for g in np.unique(grain_group):
            gsel = grain_group == g
            px = gsel[flat_labels]
            remap = np.cumsum(gsel) - 1
            s = grain_statistics(
                flat_e[px], remap[flat_labels[px]], group=str(g), device=dev
            )
            sizes[gsel] = s.sizes_px
            ecd[gsel] = s.equivalent_diameter_px
            mean_ori[gsel] = s.mean_orientation
            gos[gsel] = s.gos_deg
        stats_out = f"{prefix}_grain_stats.npz"
        payload = dict(
            sizes_px=sizes,
            equivalent_diameter_px=ecd,
            mean_orientation=mean_ori,
            gos_deg=gos,
        )
        if grain_phase is not None:
            payload["phase"] = grain_phase
        np.savez(stats_out, **payload)
        summary["grain_stats"] = stats_out
        summary["mean_ecd_px"] = float(ecd.mean())
        summary["median_ecd_px"] = float(np.median(ecd))
        summary["mean_gos_deg"] = float(gos.mean())
        summary["outputs"].append(stats_out)
    if args.parent:
        # Parent-phase reconstruction: child grain means -> OR inversion ->
        # agreement components (crystal.reconstruction). The per-pixel
        # parent orientations land as a (rows, cols, 3) Euler map so they
        # can be fed straight back into analyze (IPF map, texture, ...).
        if args.phases:
            raise SystemExit(
                "--parent reconstructs single-phase child maps; extract the "
                "child phase's pixels first"
            )
        from latice_tpu_torch.crystal import (
            grain_adjacency,
            grain_statistics,
            reconstruct_parents,
        )

        gstats = grain_statistics(orients, labels, group=args.group, device=dev)
        try:
            rec = reconstruct_parents(
                gstats.mean_orientation,
                grain_adjacency(labels),
                relationship=args.parent,
                parent_group=args.parent_group,
                child_group=args.group,
                tolerance_deg=args.parent_tolerance,
                device=dev,
            )
        except ValueError as e:
            raise SystemExit(str(e))
        parent_px = rec.parent_labels[labels]
        np.save(f"{prefix}_parent_grains.npy", parent_px)
        np.save(
            f"{prefix}_parent_orientations.npy", rec.parent_orientation[parent_px]
        )
        np.save(f"{prefix}_variants.npy", rec.variant[labels])
        np.savez(
            f"{prefix}_parent_recon.npz",
            parent_labels=rec.parent_labels,
            parent_orientation=rec.parent_orientation,
            variant=rec.variant,
            fit_deg=rec.fit_deg,
        )
        summary["n_parents"] = rec.n_parents
        summary["mean_parent_fit_deg"] = round(float(rec.fit_deg.mean()), 3)
        summary["outputs"] += [
            f"{prefix}_parent_grains.npy",
            f"{prefix}_parent_orientations.npy",
            f"{prefix}_variants.npy",
            f"{prefix}_parent_recon.npz",
        ]
    if args.taylor:
        # Full-constraints Taylor factor map (Bishop-Hill maximum work).
        if args.phases:
            raise SystemExit(
                "--taylor evaluates one phase's slip systems; run it on "
                "single-phase maps (extract one phase's pixels first)"
            )
        from latice_tpu_torch.crystal import taylor_factors

        try:
            tr = taylor_factors(
                orients, load_direction=tuple(args.load), family=args.slip_family
            )
        except ValueError as exc:
            raise SystemExit(str(exc))
        np.save(f"{prefix}_taylor.npy", tr.factor)
        summary["mean_taylor"] = round(float(tr.factor.mean()), 4)
        summary["max_taylor"] = round(float(tr.factor.max()), 4)
        summary["outputs"].append(f"{prefix}_taylor.npy")
    if args.youngs:
        # Elastic anisotropy: per-pixel directional Young's modulus under a
        # sample-frame load, plus the texture-free Hill reference.
        if args.phases:
            raise SystemExit(
                "--youngs maps one phase's stiffness; run it on single-phase "
                "maps (per-phase stiffness differs)"
            )
        from latice_tpu_torch.crystal import (
            directional_youngs_modulus,
            polycrystal_moduli,
        )

        stiff = args.youngs
        if "," in stiff:
            try:
                stiff = tuple(float(v) for v in stiff.split(","))
            except ValueError:
                raise SystemExit(
                    f"--youngs: expected C11,C12,C44 in GPa, got {args.youngs!r}"
                )
        try:
            emap = directional_youngs_modulus(
                orients, load_direction=tuple(args.load), stiffness=stiff
            )
            pm = polycrystal_moduli(stiff)
        except ValueError as exc:
            raise SystemExit(str(exc))
        np.save(f"{prefix}_youngs.npy", emap)
        summary["mean_youngs_gpa"] = round(float(emap.mean()), 2)
        summary["min_youngs_gpa"] = round(float(emap.min()), 2)
        summary["max_youngs_gpa"] = round(float(emap.max()), 2)
        summary["youngs_hill_gpa"] = round(pm.youngs_hill, 2)
        summary["outputs"].append(f"{prefix}_youngs.npy")
    if args.gnd is not None:
        # GND density lower bound from the lattice-curvature field
        # (crystal.gnd, Pantleon's five measurable Nye entries).
        if args.phases:
            raise SystemExit(
                "--gnd runs on single-phase maps (curvature across phase "
                "boundaries is undefined); extract one phase first"
            )
        from latice_tpu_torch.crystal import gnd_density

        try:
            gres = gnd_density(
                orients,
                step_um=args.step_um,
                burgers_nm=args.gnd,
                group=args.group,
                threshold_deg=args.gb_threshold,
                device=dev,
            )
        except ValueError as e:
            raise SystemExit(str(e))
        np.save(f"{prefix}_gnd.npy", gres.density)
        np.save(f"{prefix}_nye.npy", gres.alpha)
        finite = np.isfinite(gres.density)
        # None (not NaN) when every pixel is masked — the JSON summary must
        # stay RFC-8259 parseable for strict clients.
        summary["mean_gnd_per_m2"] = (
            float(gres.density[finite].mean()) if finite.any() else None
        )
        summary["gnd_valid_fraction"] = round(float(gres.valid.mean()), 4)
        summary["outputs"] += [f"{prefix}_gnd.npy", f"{prefix}_nye.npy"]
    if args.csl:
        # CSL boundary character: Σ labels per edge + number fractions.
        if args.phases:
            raise SystemExit(
                "--csl classifies single-phase cubic maps; multi-phase CSL "
                "character is not defined across phase boundaries"
            )
        from latice_tpu_torch.crystal import classify_csl_boundaries, csl_fractions

        sigmas = args.csl_sigmas.split(",") if args.csl_sigmas else None
        try:
            cmaps = classify_csl_boundaries(
                orients,
                group=args.group,
                sigmas=sigmas,
                boundary_threshold_deg=args.gb_threshold,
                brandon_base_deg=args.brandon,
                device=dev,
            )
        except ValueError as e:
            raise SystemExit(str(e))
        np.save(f"{prefix}_csl_east.npy", cmaps.east)
        np.save(f"{prefix}_csl_south.npy", cmaps.south)
        fractions = csl_fractions(cmaps)
        summary["csl_sigmas"] = list(cmaps.sigmas)
        summary["csl_fractions"] = {
            k: round(v, 4) for k, v in fractions.items() if v > 0
        }
        summary["outputs"] += [f"{prefix}_csl_{d}.npy" for d in ("east", "south")]
    if args.mdf:
        # Misorientation-angle distribution: measured boundary edges vs the
        # Mackenzie baseline for random texture (baseline uses --group; on
        # multi-phase maps the measured angles are same-phase edges only).
        from latice_tpu_torch.crystal import (
            boundary_disorientation_angles,
            random_disorientation_angles,
        )
        from latice_tpu_torch.utils._mpl import ensure_headless_backend

        angles = boundary_disorientation_angles(
            maps, threshold_deg=args.gb_threshold
        )
        if len(angles) == 0:
            raise SystemExit(
                "--mdf: no grain-boundary edges above the threshold"
            )
        ensure_headless_backend()
        import matplotlib.pyplot as plt

        base = random_disorientation_angles(args.group, n=100_000, device=dev)
        fig, ax = plt.subplots(figsize=(6, 4), dpi=120)
        bins = np.linspace(0.0, float(np.ceil(max(base.max(), angles.max()))), 41)
        ax.hist(
            angles, bins=bins, density=True, alpha=0.65,
            label=f"boundaries (n={len(angles)})",
        )
        ax.hist(
            base, bins=bins, density=True, histtype="step", lw=1.5,
            label="random (Mackenzie)",
        )
        ax.set_xlabel("disorientation (°)")
        ax.set_ylabel("density")
        ax.legend(frameon=False)
        fig.savefig(args.mdf, bbox_inches="tight")
        summary["mdf"] = args.mdf
        summary["mean_boundary_disorientation_deg"] = round(float(angles.mean()), 3)
    if args.schmid:
        # Micromechanics overlay: max Schmid factor + active system index.
        if args.phases:
            raise SystemExit(
                "--schmid evaluates one phase's slip systems; run it on "
                "single-phase maps (extract one phase's pixels first)"
            )
        from latice_tpu_torch.crystal import schmid_factors

        try:
            sr = schmid_factors(
                orients, load_direction=tuple(args.schmid), family=args.slip_family,
                device=dev,
            )
        except ValueError as e:
            raise SystemExit(str(e))
        np.save(f"{prefix}_schmid.npy", sr.max_factor)
        np.save(f"{prefix}_schmid_system.npy", sr.system)
        summary["mean_schmid"] = round(float(sr.max_factor.mean()), 4)
        summary["max_schmid"] = round(float(sr.max_factor.max()), 4)
        summary["outputs"] += [
            f"{prefix}_schmid.npy", f"{prefix}_schmid_system.npy"
        ]
    if args.components:
        # Named-texture-component volume fractions (Cube/Goss/Brass/...).
        if args.phases:
            raise SystemExit(
                "--components matches one point group's named components; "
                "run it on single-phase maps (extract one phase's pixels "
                "first, or use --odf-sections with --odf-phase)"
            )
        from latice_tpu_torch.crystal import texture_component_fractions

        comps = (
            None if args.components == "all" else args.components.split(",")
        )
        try:
            cr = texture_component_fractions(
                orients,
                components=comps,
                group=args.group,
                sample_symmetry=args.sample_symmetry,
                tolerance_deg=args.component_tolerance,
                device=dev,
            )
        except ValueError as e:
            raise SystemExit(str(e))
        np.save(f"{prefix}_components.npy", cr.labels)
        summary["component_names"] = list(cr.names)
        summary["component_fractions"] = {
            k: round(v, 4) for k, v in cr.fractions.items()
        }
        summary["outputs"].append(f"{prefix}_components.npy")
    if args.odf_sections or args.texture_index:
        # Quantitative texture: kernel-density ODF over the map's pixels
        # (per-phase on multi-phase maps via --odf-phase).
        from latice_tpu_torch.crystal import make_odf, odf_sections, texture_index

        flat = orients.reshape(-1, 3)
        odf_group = args.group
        if args.phases:
            sel = phases.reshape(-1) == args.odf_phase
            if not sel.any():
                raise SystemExit(
                    f"--odf-phase {args.odf_phase}: no pixels with that id"
                )
            flat = flat[sel]
            odf_group = groups[args.odf_phase]
        odf = make_odf(
            flat, group=odf_group, halfwidth_deg=args.odf_halfwidth, device=dev
        )
        summary["texture_index"] = round(texture_index(odf, device=dev), 4)
        if args.odf_sections:
            from latice_tpu_torch.utils import plot_odf_sections

            phi2 = [float(v) for v in args.odf_phi2.split(",")]
            secs, p1_ax, p_ax = odf_sections(odf, phi2_deg=phi2, device=dev)
            fig = plot_odf_sections(secs, p1_ax, p_ax, phi2)
            fig.savefig(args.odf_sections)
            summary["odf_sections"] = args.odf_sections
            summary["odf_max"] = round(float(secs.max()), 3)
    if args.pole_figure:
        from latice_tpu_torch.utils import plot_pole_figure

        fig = plot_pole_figure(
            orients.reshape(-1, 3), pole=tuple(args.pole), group=args.group
        )
        fig.savefig(args.pole_figure)
        summary["pole_figure"] = args.pole_figure
    if args.ipf_map:
        # The standard EBSD figure: per-pixel IPF color with grain
        # boundaries overlaid in black. Colors honor each pixel's point
        # group (per-phase groups on multi-phase maps).
        import matplotlib.image as mpimg

        from latice_tpu_torch.utils import get_color_key
        from latice_tpu_torch.utils._mpl import ensure_headless_backend

        ensure_headless_backend()
        flat = orients.reshape(-1, 3)
        if args.phases:
            rgb = np.empty((len(flat), 3), np.float32)
            flat_phase = phases.reshape(-1)
            for pid, grp in enumerate(groups):
                sel = flat_phase == pid
                if sel.any():
                    rgb[sel] = get_color_key(flat[sel], args.ipf_mode, group=grp)
        else:
            rgb = get_color_key(flat, args.ipf_mode, group=args.group)
        rgb = rgb.reshape(rows, cols, 3).astype(np.float32) / 255.0
        rgb[np.asarray(boundaries, bool)] = 0.0
        mpimg.imsave(args.ipf_map, np.clip(rgb, 0, 1))
        summary["ipf_map"] = args.ipf_map
    print(json.dumps(summary))


def register(sub, common) -> None:
    """Attach this module's subcommand parser(s)."""
    a = sub.add_parser(
        "analyze", help="grain analysis of an indexed orientation map"
    )
    a.add_argument(
        "--orientations", required=True,
        help="(N, 3) or (R, C, 3) Euler .npy from 'query'",
    )
    a.add_argument(
        "--grid", type=int, nargs=2, metavar=("ROWS", "COLS"), default=None,
        help="scan shape (required for .npy maps; .ang/.ctf inputs carry "
        "it in their header)",
    )
    a.add_argument("--group", default="432", help="point group")
    a.add_argument(
        "--clean", type=int, nargs="?", const=0, default=None,
        metavar="MIN_GRAIN_PX",
        help="OIM-style cleanup before analysis: fill unindexed pixels "
        "(from the .ang/.ctf success mask) and dissolve grains smaller "
        "than MIN_GRAIN_PX into their largest neighbor (bare --clean "
        "fills unindexed only); writes <out-prefix>_cleaned.npy",
    )
    a.add_argument(
        "--phases", default=None,
        help="per-pixel phase-id .npy (query's <out>_phase.npy) for "
        "multi-phase maps",
    )
    a.add_argument(
        "--phase-groups", default=None,
        help="comma-separated point groups, one per phase id (with --phases)",
    )
    a.add_argument(
        "--gb-threshold", type=float, default=5.0,
        help="grain-boundary misorientation threshold (deg)",
    )
    a.add_argument("--out-prefix", default="analysis")
    a.add_argument(
        "--pole-figure", default=None, help="also render a pole-figure PNG"
    )
    a.add_argument(
        "--ipf-map", default=None,
        help="also render an IPF-colored orientation map PNG with grain "
        "boundaries overlaid",
    )
    a.add_argument(
        "--ipf-mode", default="ipf_z", choices=("ipf_x", "ipf_y", "ipf_z"),
        help="IPF reference direction for --ipf-map",
    )
    a.add_argument(
        "--pole", type=float, nargs=3, default=(1.0, 0.0, 0.0),
        metavar=("H", "K", "L"), help="pole for --pole-figure",
    )
    a.add_argument(
        "--mdf", default=None, metavar="PNG",
        help="render the boundary misorientation-angle distribution against "
        "the random (Mackenzie) baseline",
    )
    a.add_argument(
        "--schmid", type=float, nargs=3, default=None, metavar=("X", "Y", "Z"),
        help="compute per-pixel max Schmid factors for a uniaxial load along "
        "this sample-frame axis (writes <prefix>_schmid.npy + _schmid_system.npy)",
    )
    a.add_argument(
        "--slip-family", default="fcc", choices=("fcc", "bcc", "bcc112"),
        help="slip-system family for --schmid",
    )
    a.add_argument(
        "--components", default=None,
        help="texture-component volume fractions: comma-separated names "
        "(cube,goss,brass,copper,s,...) or 'all'",
    )
    a.add_argument(
        "--component-tolerance", type=float, default=15.0,
        help="assignment radius (deg) for --components",
    )
    a.add_argument(
        "--sample-symmetry", default="orthorhombic",
        choices=("triclinic", "monoclinic", "orthorhombic"),
        help="specimen symmetry for --components (rolled sheet = orthorhombic)",
    )
    a.add_argument(
        "--odf-sections", default=None, metavar="PNG",
        help="render constant-φ2 ODF sections (kernel-density ODF) to PNG "
        "and report the texture index",
    )
    a.add_argument(
        "--odf-phi2", default="0,45,65",
        help="comma-separated φ2 section angles (deg) for --odf-sections",
    )
    a.add_argument(
        "--odf-halfwidth", type=float, default=10.0,
        help="ODF kernel half-width (deg, de la Vallée Poussin)",
    )
    a.add_argument(
        "--odf-phase", type=int, default=0,
        help="phase id whose texture to analyze on multi-phase maps",
    )
    a.add_argument(
        "--texture-index", action="store_true",
        help="report the texture index J = ∫f² (1 = random) without "
        "rendering sections",
    )
    a.add_argument(
        "--grain-stats", action="store_true",
        help="also compute per-grain statistics (size, ECD, mean "
        "orientation, GOS) into <prefix>_grain_stats.npz",
    )
    a.add_argument(
        "--csl", action="store_true",
        help="classify grain-boundary edges by CSL type (Σ3 twins etc., "
        "Brandon criterion; cubic maps)",
    )
    a.add_argument(
        "--csl-sigmas", default=None,
        help="comma-separated Σ values to test (e.g. 3,9,27a); "
        "default: the full Σ3-Σ29 table",
    )
    a.add_argument(
        "--brandon", type=float, default=15.0,
        help="Brandon-criterion base angle (deg); tolerance per Σ is base/√Σ",
    )
    a.add_argument(
        "--taylor", action="store_true",
        help="full-constraints Taylor factor map (Bishop-Hill) under "
        "uniaxial tension along --load, slip systems from --slip-family",
    )
    a.add_argument(
        "--youngs", default=None, metavar="STIFFNESS",
        help="directional Young's modulus map (GPa): a material name "
        "(al, cu, ni, fe-alpha, fe-gamma, w) or C11,C12,C44 in GPa",
    )
    a.add_argument(
        "--load", type=float, nargs=3, default=(0.0, 0.0, 1.0),
        metavar=("X", "Y", "Z"),
        help="sample-frame load direction for --youngs (default: 0 0 1)",
    )
    a.add_argument(
        "--gnd", type=float, default=None, metavar="BURGERS_NM",
        help="compute the GND density lower bound (1/m²) with this Burgers "
        "vector length in nm (e.g. 0.248 for α-Fe, 0.286 for Al)",
    )
    a.add_argument(
        "--step-um", type=float, default=1.0,
        help="scan step in micrometres for curvature units "
        "(default: %(default)s)",
    )
    a.add_argument(
        "--parent", default=None, metavar="OR",
        help="reconstruct prior-phase parent grains through this orientation "
        "relationship (ks | nw | bain | pitsch); child phase is --group",
    )
    a.add_argument(
        "--parent-group", default="432",
        help="point group of the parent phase (default: %(default)s)",
    )
    a.add_argument(
        "--parent-tolerance", type=float, default=2.5,
        help="max disorientation (deg) for two child grains to agree on a "
        "parent candidate (default: %(default)s)",
    )
    a.add_argument("--device", default=None, help="torch device (default: cuda)")
    a.set_defaults(fn=cmd_analyze)

