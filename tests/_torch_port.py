"""Shared set-up for the port's tests (tests/test_torch_*.py): one small
configuration for both packages, seeded numpy inputs, and JAX variables
with non-trivial biases and BatchNorm statistics so every weight mapping
shows up in the outputs."""

from __future__ import annotations

import numpy as np

# The small sizes the JAX package's own model tests use (test_multiquery.py).
SMALL = dict(
    resize_img=(64, 64), max_qlen=8, lstm_dim=8, emb_dim=8, fpn_ch=16, head_ch=16,
    compute_dtype="float32", use_level_path=False, do_dist=False,
)
QUERIES = [
    "the red box",
    "a blue ellipse on the left",
    "the left thing",
    "red box",
    "a blue box",
]


def cfg_pair(**kw):
    """The same configuration in the JAX package and in the port."""
    from zsgnet_tpu.config import Config as JConfig
    from zsgnet_tpu_torch.config import Config as TConfig

    args = {**SMALL, **kw}
    return JConfig(**args), TConfig(**args)


def random_batch(rng: np.random.Generator, b: int, cfg, vocab_size: int) -> dict[str, np.ndarray]:
    h, w = cfg.resize_img
    t = cfg.max_qlen
    lo = rng.uniform(-1.0, 0.5, size=(b, 2))
    annot = np.concatenate([lo, lo + rng.uniform(0.2, 0.9, size=(b, 2))], axis=1)
    return {
        "img": rng.integers(0, 256, size=(b, h, w, 3)).astype(np.uint8),
        "qvec": rng.integers(1, vocab_size, size=(b, t)).astype(np.int32),
        "qlens": rng.integers(1, t + 1, size=(b,)).astype(np.int32),
        "annot": np.clip(annot, -1.0, 1.0).astype(np.float32),
    }


def grouped_batch(rng: np.random.Generator, cfg, b: int, q: int, vocab_size: int) -> dict[str, np.ndarray]:
    """b images with q queries each; image 1's last query repeats its first
    (a wrap-repeat, ``pair_valid`` 0)."""
    flat = random_batch(rng, b * q, cfg, vocab_size)
    batch = {
        "img": flat["img"][:b],
        "qvec": flat["qvec"].reshape(b, q, -1),
        "qlens": flat["qlens"].reshape(b, q),
        "annot": flat["annot"].reshape(b, q, 4),
        "pair_valid": np.ones((b, q), bool),
    }
    for k in ("qvec", "qlens", "annot"):
        batch[k][1, q - 1] = batch[k][1, 0]
    batch["pair_valid"][1, q - 1] = False
    return batch


def jax_variables(jcfg, vocab_size: int, seed: int = 0) -> dict:
    """A random JAX ZSGNet init, as numpy, with every bias, BatchNorm scale
    and running statistic perturbed from its default."""
    import jax
    from flax import traverse_util

    from zsgnet_tpu.models.zsgnet import get_default_net

    model = get_default_net(jcfg, vocab_size=vocab_size)
    h, w = jcfg.resize_img
    sample = {
        "img": np.zeros((2, h, w, 3), np.uint8),
        "qvec": np.ones((2, jcfg.max_qlen), np.int32),
        "qlens": np.full((2,), 3, np.int32),
    }
    variables = jax.jit(lambda r, b: model.init(r, b, train=False))(
        jax.random.PRNGKey(seed), sample
    )
    rng = np.random.default_rng(seed)
    out = {}
    for coll in ("params", "batch_stats"):
        if coll not in variables:  # SSD-VGG has no BatchNorm
            continue
        flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, dict(variables[coll])))
        for path, x in flat.items():
            name = path[-1]
            if name.endswith("bias"):
                x = x + rng.normal(0.0, 0.1, x.shape)
            elif name == "scale":
                x = rng.uniform(0.8, 1.2, x.shape)
            elif name == "mean":
                x = rng.uniform(-0.3, 0.3, x.shape)
            elif name == "var":
                x = rng.uniform(0.7, 1.5, x.shape)
            flat[path] = np.asarray(x, np.float32)
        out[coll] = traverse_util.unflatten_dict(flat)
    return out


def port_model(tcfg, variables, vocab_size: int):
    """The port's ZSGNet on the CPU carrying the JAX weights."""
    from zsgnet_tpu_torch.convert import state_dict_from_jax
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet

    model = ZSGNet(tcfg, vocab_size)
    model.load_state_dict(state_dict_from_jax(variables, tcfg))
    return model.eval()
