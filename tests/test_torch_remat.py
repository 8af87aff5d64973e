"""``cfg.remat_backbone`` in the port: each ResNet-50 bottleneck under
``torch.utils.checkpoint`` in training mode, recomputed in the backward
pass with its BatchNorm statistics left alone.

* One train step (Adam, lr 1e-6) with and without remat from the same
  weights on the same batch, float32 on the CPU: the loss, every gradient
  and every parameter after the step bit-identical (the recomputation
  runs the same kernels on the same inputs), and the BatchNorm running
  statistics and ``num_batches_tracked`` equal, the momentum applied once.
* The same step's BatchNorm statistics against the JAX step with
  ``remat_backbone=True`` (flax's ``nn.remat``): rtol 1e-4 / atol 1e-5, as
  tests/test_torch_train_step.py holds the step without remat.
* The bottlenecks really are recomputed: a block runs twice per step under
  remat (the second time with its statistics frozen), once without, and
  once in evaluation mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from _torch_port import cfg_pair, random_batch
from zsgnet_tpu.convert.torch_import import convert_zsgnet_checkpoint
from zsgnet_tpu.models.zsgnet import anchor_pyramid_for as j_anchor_pyramid
from zsgnet_tpu.models.zsgnet import get_default_net as j_net
from zsgnet_tpu.parallel import train_step as jts
from zsgnet_tpu_torch.models.resnet import Bottleneck
from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for, init_weights
from zsgnet_tpu_torch.parallel import train_step as tts

torch.set_num_threads(1)

VOCAB = 30
HEAD = ("head.conv0", "head.conv1", "head.conv2", "head.conv3", "head.out")


def _counted(forward, calls: list, bn):
    def run(x):
        calls.append(bn.frozen_stats)
        return forward(x)

    return run


@functools.lru_cache(maxsize=None)
def _steps() -> dict:
    """One port step with and without remat, from the same weights; the
    block calls of each."""
    _, tcfg = cfg_pair(bs=4, lr=1e-6, remat_backbone=True)
    init = init_weights(ZSGNet(tcfg, VOCAB), seed=1).state_dict()
    batch = random_batch(np.random.default_rng(24), 4, tcfg, VOCAB)
    out = {"init": init, "batch": batch}
    for remat in (True, False):
        cfg = tcfg.replace(remat_backbone=remat)
        model = ZSGNet(cfg, VOCAB)
        model.load_state_dict(init)
        calls = []  # frozen_stats of layer2[1]'s BatchNorms at each of its forwards
        block = model.backbone["encoder"].layer2[1]
        block.forward = _counted(block.forward, calls, block.bn1)
        grads = {}
        for n, p in model.named_parameters():
            if p.requires_grad:  # the LSTM's bias_hh is frozen
                p.register_hook(lambda g, n=n: grads.__setitem__(n, g.clone()))
        state = tts.create_train_state(cfg, model)
        _, ls = tts.make_train_step(cfg, anchor_pyramid_for(cfg), device="cpu")(state, batch)
        out[remat] = {"loss": float(ls["total"]), "grads": grads, "sd": model.state_dict(),
                      "calls": calls, "model": model}
    return out


def test_remat_step_equals_the_plain_step():
    r = _steps()
    on, off = r[True], r[False]
    assert on["loss"] == off["loss"]
    assert set(on["grads"]) == set(off["grads"]) and len(on["grads"]) > 100
    for n, g in off["grads"].items():
        assert torch.equal(on["grads"][n], g), n
    for k, v in off["sd"].items():
        assert torch.equal(on["sd"][k], v), k
    tracked = [k for k in on["sd"] if k.endswith("num_batches_tracked")]
    assert len(tracked) == 53 and all(int(on["sd"][k]) == 1 for k in tracked)


def test_remat_recomputes_each_bottleneck():
    r = _steps()
    assert (r[True]["calls"], r[False]["calls"]) == ([False, True], [False])
    model = r[True]["model"]
    calls = []
    blocks = [m for m in model.modules() if isinstance(m, Bottleneck)]
    for m in blocks:
        m.forward = _counted(m.forward, calls, m.bn1)
    b = tts.to_device(r["batch"], torch.device("cpu"))
    model.eval()
    with torch.no_grad():
        model(b["img"], b["qvec"], b["qlens"])
    assert calls == [False] * len(blocks) and len(blocks) == 16


def test_remat_bn_statistics_match_jax_remat_step():
    r = _steps()
    jcfg, tcfg = cfg_pair(bs=4, lr=1e-6, remat_backbone=True)
    variables = jax.tree.map(np.asarray, convert_zsgnet_checkpoint(
        r["init"], head_conv_prefixes=HEAD, num_anchors=tcfg.num_anchors))
    tx = jts.make_optimizer(jcfg)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        lr_scale=jnp.ones((), jnp.float32), tx=tx, apply_fn=j_net(jcfg, vocab_size=VOCAB).apply,
        ema_params=None,
    )
    batch = r["batch"]
    jstate, jl = jts.make_train_step(jcfg, j_anchor_pyramid(jcfg), mesh=None)(
        jstate, {k: batch[k] for k in ("img", "qvec", "qlens", "annot")})
    np.testing.assert_allclose(r[True]["loss"], float(jl["total"]), rtol=1e-5)
    want = traverse_util.flatten_dict(jax.tree.map(np.asarray, jstate.batch_stats))
    got = traverse_util.flatten_dict(jax.tree.map(np.asarray, convert_zsgnet_checkpoint(
        r[True]["sd"], head_conv_prefixes=HEAD, num_anchors=tcfg.num_anchors)["batch_stats"]))
    assert set(got) == set(want)
    for k, x in want.items():
        np.testing.assert_allclose(got[k], x, rtol=1e-4, atol=1e-5, err_msg=str(k))
