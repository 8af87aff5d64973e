"""The port's grouped multi-query train step (``cfg.queries_per_img``)
on the CPU at 64², fpn_ch/head_ch 16, B = 2 images × Q = 3 queries.

The grouped train step against JAX's grouped step from the same weights
on the same batch, with a wrap-repeated pair masked by ``pair_valid``:
loss rtol 1e-5; gradients by relative L2 over all of them, 5e-2
(measured 1.4e-2, all of it the backbone's: its train-mode BatchNorm
gradients differ by ~2 % between the two float32 frameworks, as
tests/test_torch_train_step.py records), and per leaf of the heads, the
FPN, the LSTM and the embedding, 1e-3 (measured ≤ 1.2e-4); after one Adam
step at lr 1e-6 (ROADMAP.md queue 3: training at this size is chaotic at
larger rates) the update agrees to relative L2 0.25 and the BatchNorm
statistics to rtol 1e-4 / atol 1e-5, as tests/test_torch_train_step.py.

The grouped step against the port's own flat step over the images
repeated Q times, in float64: the loss to rtol 1e-6, every gradient to
relative L2 1e-6, the BatchNorm statistics to rtol 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_port import cfg_pair, grouped_batch, jax_variables, port_model
from zsgnet_tpu.convert.torch_import import convert_zsgnet_checkpoint
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu.models.zsgnet import anchor_pyramid_for as j_anchor_pyramid
from zsgnet_tpu.parallel import train_step as jts
from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for, init_weights
from zsgnet_tpu_torch.parallel import train_step as tts

torch.set_num_threads(1)

VOCAB = 30
B, Q = 2, 3
HEAD = ("head.conv0", "head.conv1", "head.conv2", "head.conv3", "head.out")


def _flat_grads(model: torch.nn.Module, cfg) -> dict[str, np.ndarray]:
    """The port's gradients in the JAX parameter layout."""
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    for n, p in model.named_parameters():
        if p.grad is not None:
            sd[n] = p.grad.detach().clone()
    conv = convert_zsgnet_checkpoint(sd, head_conv_prefixes=HEAD, num_anchors=cfg.num_anchors)
    return traverse_util.flatten_dict(jax.tree.map(np.asarray, conv["params"]))


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / (np.linalg.norm(b) + 1e-30))


@functools.lru_cache(maxsize=None)
def _grouped_vs_jax() -> dict:
    jcfg, tcfg = cfg_pair(bs=B, queries_per_img=Q, lr=1e-6)
    batch = grouped_batch(np.random.default_rng(5), tcfg, B, Q, VOCAB)
    variables = jax_variables(jcfg, VOCAB, seed=1)
    jmodel = JZSGNet(cfg=jcfg, vocab_size=VOCAB)
    jbatch = {k: jnp.asarray(batch[k]) for k in jts.train_batch_keys(jcfg)}
    compute_loss = jts.make_compute_loss(jcfg, j_anchor_pyramid(jcfg), None)

    def j_total(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              {k: jbatch[k] for k in ("img", "qvec", "qlens")},
                              train=True, mutable=["batch_stats"])
        return compute_loss(out, jbatch["annot"].reshape(-1, 4),
                            sample_weight=jbatch["pair_valid"].reshape(-1).astype(jnp.float32))["total"]

    j_loss, j_grads = jax.jit(jax.value_and_grad(j_total))(variables["params"])

    tx = jts.make_optimizer(jcfg)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        lr_scale=jnp.ones((), jnp.float32), tx=tx, apply_fn=jmodel.apply, ema_params=None,
    )
    jstate, jl = jts.make_train_step(jcfg, j_anchor_pyramid(jcfg), mesh=None)(jstate, jbatch)

    model = port_model(tcfg, variables, VOCAB).train()
    b = tts.to_device(batch, torch.device("cpu"))
    out = model(b["img"], b["qvec"], b["qlens"])
    annot, w = tts.pairs_and_weights(b)
    ls = tts.make_compute_loss(tcfg, anchor_pyramid_for(tcfg), "cpu")(out, annot, w)
    ls["total"].backward()
    t_grads = _flat_grads(model, tcfg)

    model = port_model(tcfg, variables, VOCAB)
    p0 = {k: v.clone() for k, v in model.state_dict().items()}
    state = tts.create_train_state(tcfg, model)
    _, tl = tts.make_train_step(tcfg, anchor_pyramid_for(tcfg), device="cpu")(state, batch)
    to_jax = lambda sd: {c: traverse_util.flatten_dict(jax.tree.map(np.asarray, v)) for c, v in  # noqa: E731
                         convert_zsgnet_checkpoint(sd, head_conv_prefixes=HEAD,
                                                   num_anchors=tcfg.num_anchors).items()}
    return {
        "j_loss": float(j_loss), "t_loss": float(ls["total"].detach()),
        "j_step_loss": float(jl["total"]), "t_step_loss": float(tl["total"]),
        "j_grads": traverse_util.flatten_dict(jax.tree.map(np.asarray, j_grads)), "t_grads": t_grads,
        "p0": to_jax(p0)["params"], "port": to_jax(model.state_dict()),
        "jax": {"params": traverse_util.flatten_dict(jax.tree.map(np.asarray, jstate.params)),
                "batch_stats": traverse_util.flatten_dict(jax.tree.map(np.asarray, jstate.batch_stats))},
    }


def test_grouped_loss_and_gradients_match_jax():
    r = _grouped_vs_jax()
    np.testing.assert_allclose(r["t_loss"], r["j_loss"], rtol=1e-5)
    np.testing.assert_allclose(r["t_step_loss"], r["j_step_loss"], rtol=1e-5)
    tg, jg = r["t_grads"], r["j_grads"]
    assert set(tg) == set(jg)
    keys = sorted(jg)
    assert _rel(np.concatenate([tg[k].ravel() for k in keys]),
                np.concatenate([jg[k].ravel() for k in keys])) <= 5e-2
    for k in keys:
        if k[0] != "backbone":
            assert _rel(tg[k], jg[k]) <= 1e-3, k


def test_grouped_adam_step_and_bn_statistics_match_jax():
    r = _grouped_vs_jax()
    want, got, p0 = r["jax"]["params"], r["port"]["params"], r["p0"]
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    assert np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want) <= 0.25
    for k, x in r["jax"]["batch_stats"].items():
        np.testing.assert_allclose(r["port"]["batch_stats"][k], x, rtol=1e-4, atol=1e-5, err_msg=str(k))


@pytest.mark.parametrize("mdl", ["retina", "ssd_vgg"])
def test_grouped_step_equals_the_repeated_image_flat_step(mdl):
    """In float64 (``model.double()``; the loss stays float32): in float32
    the retina backbone's BatchNorm backward alone moves the two by up to
    2.6 % (measured), against 1.4e-12 in float64 (1.4e-7 for SSD, whose
    loss-side float32 rounding then dominates)."""
    _, tcfg_g = cfg_pair(bs=B, queries_per_img=Q, lr=1e-6, mdl_to_use=mdl)
    tcfg_f = tcfg_g.replace(bs=B * Q, queries_per_img=1)
    batch = grouped_batch(np.random.default_rng(6), tcfg_g, B, Q, VOCAB)
    batch["pair_valid"][:] = True
    flat = {"img": np.repeat(batch["img"], Q, axis=0), "qvec": batch["qvec"].reshape(B * Q, -1),
            "qlens": batch["qlens"].reshape(-1), "annot": batch["annot"].reshape(-1, 4)}
    init = init_weights(ZSGNet(tcfg_g, VOCAB), seed=4).state_dict()

    def run(cfg, b):
        model = ZSGNet(cfg, VOCAB)
        model.load_state_dict(init)
        model.double().train()
        d = tts.to_device(b, torch.device("cpu"))
        out = model(d["img"], d["qvec"], d["qlens"])
        annot, w = tts.pairs_and_weights(d)
        ls = tts.make_compute_loss(cfg, anchor_pyramid_for(cfg), "cpu")(out, annot, w)
        ls["total"].backward()
        grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
        return float(ls["total"].detach()), float(ls["num_pos"].detach()), grads, model.state_dict()

    lg, pg, gg, sg = run(tcfg_g, batch)
    lf, pf, gf, sf = run(tcfg_f, flat)
    np.testing.assert_allclose(lg, lf, rtol=1e-6)
    assert pg == pf
    assert set(gg) == set(gf)
    for k in gf:
        assert _rel(gg[k], gf[k]) <= 1e-6, k
    for k in sf:
        if "running" in k or "tracked" in k:
            np.testing.assert_allclose(sg[k].numpy(), sf[k].numpy(), rtol=1e-9, atol=1e-12, err_msg=k)


