"""The plain reference held against latice_tpu_torch on the CPU at tiny
sizes: the encoder's latents, the cosine top-k, the consensus, and one
AMSGrad training step's loss and update."""

import numpy as np
import pytest
import torch

from port_bench import check, gen
from port_bench.reference import consensus as ref_consensus
from port_bench.reference import rotations as rot
from port_bench.reference import vae as ref
from port_bench.reference.search import cosine_scores

TINY = dict(inplanes=4, latent_dim=8, n_stages=3, bottleneck_hw=4, image_size=32, precision="32",
            kl_lambda=5e-6, learning_rate=1e-4, amsgrad=True)


def _model(cfg, params):
    from port_bench import program

    return program.model(cfg, params, "cpu")


def _patterns(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32), dtype=np.uint8)


def test_param_layout_is_the_ports_state_dict():
    from latice_tpu_torch.models import VariationalAutoEncoderRawData

    for cfg in (TINY, dict(TINY, n_stages=4, bottleneck_hw=2)):
        port = VariationalAutoEncoderRawData(cfg["inplanes"], cfg["latent_dim"], cfg["n_stages"],
                                             cfg["bottleneck_hw"]).state_dict()
        layout = {n: s for n, s, _ in ref.param_layout(cfg)}
        assert layout == {k: tuple(v.shape) for k, v in port.items()}


def test_latents_match_the_port_in_float32():
    params = gen.weights(ref.param_layout(TINY), "cpu", 3)
    x = _patterns(16)
    with torch.no_grad():
        port = _model(TINY, params).encode(torch.as_tensor(x).float()[:, None] / 255.0)[0]
    torch.testing.assert_close(check.encode(params, TINY, x, "cpu"), port, rtol=1e-4, atol=1e-5)


def test_topk_matches_the_fused_engines_plain_twin():
    from latice_tpu_torch.ops.topk_fused import cosine_topk_fused_plain

    g = torch.Generator().manual_seed(0)
    q, d = torch.randn(32, 16, generator=g), torch.randn(500, 16, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    scores, idx = cosine_topk_fused_plain(q, d, 20)
    ref_scores = cosine_scores(q, d)
    torch.testing.assert_close(torch.gather(ref_scores, 1, idx), scores, rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.topk(ref_scores, 20).values, scores, rtol=0, atol=1e-6)


@pytest.mark.parametrize("groups", [["432"], ["432", "622"]])
def test_consensus_matches_the_port(groups):
    from latice_tpu_torch.crystal import stack_symmetry_tables
    from latice_tpu_torch.index.consensus import consensus_orientations

    cfg = dict(latent_dim=8, cluster_rows=5, cluster_spread=0.01, cluster_degrees=2.0,
               rows_per_phase=200, phases=groups)
    _, euler, phases = gen.dictionary(cfg, "cpu", 11)
    rng = np.random.default_rng(1)
    idx = np.stack([rng.choice(np.arange(c, c + 10) % len(euler), 6, replace=False)
                    for c in rng.integers(0, len(euler), 64)])
    quats = rot.from_euler_zxz_deg(euler)
    multi = len(groups) > 1
    got = consensus_orientations(
        torch.as_tensor(quats[idx]), 3.0, min_required_matches=4, max_iterations=3,
        cand_phases=torch.as_tensor(phases[idx]) if multi else None,
        sym_tables=stack_symmetry_tables(groups, dtype=torch.float64) if multi else None,
    )
    want = ref_consensus.consensus(quats[idx], 3.0, 4, 3, phases[idx] if multi else None, groups)
    assert 0 < want.success.sum() < len(idx)
    np.testing.assert_array_equal(got.success.numpy(), want.success)
    np.testing.assert_array_equal(got.similar_mask.sum(1).numpy(), want.n_similar)
    mean = rot.from_euler_zxz_deg(got.mean_euler.numpy())
    ok = want.success
    assert np.rad2deg(rot.misorientation(mean[ok], want.mean[ok])).max() < 1e-6
    if multi:
        np.testing.assert_array_equal(got.phase.numpy(), want.phase)


def test_point_groups():
    for name, n in (("432", 24), ("622", 12)):
        g = rot.point_group(name)
        assert g.shape == (n, 4)
        closed = rot.mul(g[:, None], g[None, :]).reshape(-1, 4)
        near = np.abs(closed @ g.T).max(1)
        np.testing.assert_allclose(near, 1.0, atol=1e-12)


def _program_noise(seed: int, step: int, shape) -> torch.Tensor:
    """The reparameterization noise the port's train step ``step`` draws: a
    generator seeded from ``SeedSequence([seed, 1, step])``'s two words, as
    ``train.steps.keyed_generator`` documents."""
    words = np.random.SeedSequence([seed, 1, step]).generate_state(2, np.uint32)
    gen_ = torch.Generator().manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return torch.randn(shape, generator=gen_, dtype=torch.float32)


def _reference_step(cfg, params0, x, eps):
    """One reference AMSGrad step: the loss, the gradient, the parameters."""
    params = {k: v.detach().clone() for k, v in params0.items()}
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = ref.forward_loss(leaves, cfg, torch.as_tensor(x), eps)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    with torch.no_grad():
        ref.amsgrad(params, grads, {}, cfg["learning_rate"])
    return float(loss.detach()), grads, params


def test_one_train_step_matches_the_port():
    from latice_tpu_torch.train import VAEModule, make_train_step
    from latice_tpu_torch.train.state import make_optimizer

    params = gen.weights(ref.param_layout(TINY), "cpu", 5)
    net = _model(TINY, params)
    module = VAEModule(net, kl_lambda=TINY["kl_lambda"], lr_scheduler_partial=None,
                       optimizer_partial=lambda p: make_optimizer(p, 1e-4, True)).with_precision("32")
    opt = module.configure_optimizer()
    step = make_train_step(module.loss_fn, seed=9)
    # Continuous values: uint8 frames tie in the max-pools, and a tie that
    # rounds the other way sends a pixel's gradient elsewhere.
    x = np.random.default_rng(0).random((4, 1, 32, 32), dtype=np.float32)
    metrics = step(net, opt, torch.as_tensor(x), None, 0)
    eps = _program_noise(9, 0, (4, TINY["latent_dim"]))
    loss, first, after = _reference_step(TINY, params, x, eps)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-5)
    median = np.median([float(g.norm()) for g in first.values()])
    for name, p in net.named_parameters():
        torch.testing.assert_close(opt.state[p]["mu"] / np.float32(0.1), first[name], rtol=1e-3, atol=1e-7)
        # A bias before an instance norm has no gradient but round-off, which
        # Adam's first step turns into +-lr: the benchmark leaves it out too.
        if float(first[name].norm()) >= 1e-3 * median:
            torch.testing.assert_close(p.detach(), after[name], rtol=1e-5, atol=1e-6)


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in (Path(ref.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        tops = {name.split(".")[0] for name in names}
        assert not tops & {"jax", "jaxlib", "flax", "latice_tpu", "latice_tpu_torch"}, path
