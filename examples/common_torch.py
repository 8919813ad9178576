"""What the examples' twins (``examples/*_torch.py``) share: the model
the JAX scripts start from, their device-resident training loop, the
dictionary encode, and the optional figure backend.

The JAX scripts build their model with ``model.init({"params": key(s)})``;
`jax_init_state_dict` draws those very weights in numpy (JAX's threefry
PRNG and flax's per-parameter keys), so every twin starts where its JAX
script starts without importing JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def dictionary_grid(side: int = 16) -> np.ndarray:
    """``(side**3, 3)`` zxz Euler degrees: a ``side``-point grid over a
    30-degree box (2-degree spacing at 16)."""
    g = np.linspace(0, 30, side)
    z1, x_, z2 = np.meshgrid(g, g + 40, g, indexing="ij")
    return np.stack([z1.ravel(), x_.ravel(), z2.ravel()], -1)


# JAX's default PRNG (threefry2x32, `jax_threefry_partitionable` on, the
# default since JAX 0.5) and flax's per-parameter keys, in numpy: the port's
# counterpart of ``model.init({"params": key(seed)}, ...)`` draws the very
# numbers the JAX scripts start from (to the last bit of ``erf_inv``).
def _threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs ``(x0, x1)``."""
    u32 = np.uint32
    k0, k1 = u32(key[0]), u32(key[1])
    ks = [k0, k1, u32(k0 ^ k1 ^ u32(0x1BD11BDA))]
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = np.asarray(x0, u32) + ks[0]
    x1 = np.asarray(x1, u32) + ks[1]
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def _fold_in(key, data: int):
    """``jax.random.fold_in`` of a uint32."""
    y0, y1 = _threefry2x32(key, [0], [data])
    return y0[0], y1[0]


def _truncated_normal(key, shape) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape)`` in float32."""
    from scipy.special import erf, erfinv

    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = _threefry2x32(key, hi, lo)
    floats = (((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - 1
    sqrt2 = np.float32(np.sqrt(2))
    a = np.float32(erf(np.float32(-2) / sqrt2))
    b = np.float32(erf(np.float32(2) / sqrt2))
    u = np.maximum(a, floats * (b - a) + a)
    out = sqrt2 * erfinv(u.astype(np.float64)).astype(np.float32)
    lim = np.nextafter(np.float32(2), np.float32(0))
    return np.clip(out, -lim, lim).reshape(shape)


def _flax_param_key(seed: int, path: tuple[str, ...], counter: int):
    """The key flax gives the ``counter``-th parameter of the module at
    ``path`` under ``init({"params": key(seed)})``: the root key folded
    with the first four bytes of the SHA-1 of the path and the counter."""
    import hashlib

    digest = hashlib.sha1()
    for part in (*path, counter):
        if isinstance(part, str):
            digest.update(part.encode("utf-8"))
        else:
            digest.update(part.to_bytes((part.bit_length() + 7) // 8, byteorder="big"))
    root = (np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF))
    return _fold_in(root, int.from_bytes(digest.digest()[:4], byteorder="big"))


def jax_init_state_dict(seed: int, inplanes=32, latent_dim=16, n_stages=5,
                        bottleneck_hw=4) -> dict:
    """The port's state dict of the JAX VAE's ``init({"params":
    key(seed)}, ...)``: every kernel a LeCun-normal draw (a normal
    truncated at two standard deviations, ``std = 1/sqrt(fan_in) /
    0.8796``, fan-in over the kernel window and input features), every
    bias zero, carried into the torch layout by
    `flax_params_to_state_dict`."""
    from latice_tpu_torch.models import flax_params_to_state_dict

    def layer(path, shape):
        k = _truncated_normal(_flax_param_key(seed, path, 1), shape)
        fan_in = int(np.prod(shape[:-1]))
        std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
        return {"kernel": k * std, "bias": np.zeros(shape[-1], np.float32)}

    widths = [inplanes, 2 * inplanes] + [4 * inplanes] * (n_stages - 2)
    params = {"encoder": {}, "decoder": {}}
    c_in = 1
    for s, c in enumerate(widths):
        for b in range(2):
            name = f"stage{s}_block{b}"
            params["encoder"][name] = {"conv": layer(("encoder", name, "conv"), (3, 3, c_in, c))}
            c_in = c
    flat = 4 * inplanes * bottleneck_hw * bottleneck_hw
    for head in ("mu", "logvar"):
        params[head] = layer((head,), (flat, latent_dim))
    params["linear2"] = layer(("linear2",), (latent_dim, flat))
    p = inplanes
    stages = [(4 * p, 4 * p)] * (n_stages - 3) + [(4 * p, 2 * p), (2 * p, p), (p,)]
    c_in = 4 * p
    for s, outs in enumerate(stages):
        for b, c in enumerate(outs):
            name = f"stage{s}_block{b}"
            params["decoder"][name] = {"conv": layer(("decoder", name, "conv"), (3, 3, c_in, c))}
            c_in = c
    params["decoder"]["logit_conv"] = layer(("decoder", "logit_conv"), (3, 3, c_in, 1))
    return flax_params_to_state_dict(params, inplanes, latent_dim, n_stages, bottleneck_hw)


def make_model(inplanes=32, latent_dim=16, n_stages=5, bottleneck_hw=4,
               precision="16-mixed", state_dict=None, init_seed=0, device="cuda"):
    """The script's model on ``device``: ``state_dict`` when given, else
    JAX's ``init`` from ``key(init_seed)`` (`jax_init_state_dict`);
    ``precision="16-mixed"`` is the JAX script's ``dtype=bfloat16``."""
    from latice_tpu_torch import resolve_device
    from latice_tpu_torch.models import VariationalAutoEncoderRawData

    dev = resolve_device(device)
    model = VariationalAutoEncoderRawData(inplanes, latent_dim, n_stages, bottleneck_hw)
    if state_dict is None:
        state_dict = jax_init_state_dict(init_seed, inplanes, latent_dim, n_stages,
                                         bottleneck_hw)
    model.load_state_dict(state_dict)
    return model.set_precision(precision).to(dev)


def train_resident(model, xd: torch.Tensor, steps: int, batch: int, rng, seed: int,
                   eps_fn=None):
    """The scripts' device-resident loop: each step draws ``batch`` row
    indices on the host from ``rng``, gathers them from the resident
    ``xd`` (``index_select``, the port of ``jnp.take``) and takes one
    AMSGrad step at the scripts' rate of 3e-4 and KL weight of 5e-6
    (`make_optimizer`, as ``create_train_state``). The noise
    of step ``s`` is keyed by ``(seed, s)``, or ``eps_fn(s)`` when given.
    Returns the last step's metrics."""
    from latice_tpu_torch.train import VAELoss, make_optimizer, make_train_step

    opt = make_optimizer(model.parameters(), learning_rate=3e-4)
    loss_fn = VAELoss(kl_lambda=5e-6)
    step_fn = make_train_step(loss_fn, seed=seed)
    metrics = None
    for s in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(xd), size=batch)).to(xd.device)
        eps = None if eps_fn is None else eps_fn(s).to(xd.device)
        metrics = step_fn(model, opt, xd.index_select(0, idx), step=s, eps=eps)
    return metrics


@torch.inference_mode()
def encode_dictionary(model, xd: torch.Tensor, chunk: int = 512) -> np.ndarray:
    """Unit latents of a resident ``(N, 1, H, W)`` stack, 512 at a time."""
    model.eval()
    lat = torch.cat([model.encode(xd[i : i + chunk])[0] for i in range(0, len(xd), chunk)])
    lat = lat.cpu().numpy()
    return lat / np.linalg.norm(lat, axis=1, keepdims=True)


def resident_stack(patterns: np.ndarray, device) -> torch.Tensor:
    """``(N, H, W)`` host patterns as an ``(N, 1, H, W)`` f32 device stack."""
    return torch.from_numpy(np.ascontiguousarray(patterns[:, None], np.float32)).to(device)


def pyplot_or_none():
    """``matplotlib.pyplot`` on the headless backend, or None (with a
    printed note) where matplotlib is not installed: the demos then skip
    their figures and still print every figure they compute."""
    import importlib.util

    if importlib.util.find_spec("matplotlib") is None:
        print("figure skipped: matplotlib is not installed")
        return None
    from latice_tpu_torch.utils._mpl import ensure_headless_backend

    ensure_headless_backend()
    import matplotlib.pyplot as plt

    return plt
