"""The port's training math against the JAX package on the CPU.

* K2's plain version (the closed-form backward of the fused loss) against
  torch autograd of K1's plain version, and the port's loss gradients
  against ``jax.grad`` through the JAX Pallas VJP in interpret mode:
  atol 1e-6 on gradients of order 0.1 (float32, other operation order).
* ``lr_schedule_scale`` against the JAX one: rtol 1e-6 (both in float32).
* The optimizers against optax on random tensors: rtol 1e-5, atol 1e-7
  after three steps (float32, Adam's sqrt and division in another order).
* The train step against JAX ``make_train_step(cfg, anchors, mesh=None)``:
  the same weights (the port's seeded init, mapped to JAX by the JAX
  package's converter and back by ``state_dict_from_jax``) and the same
  B = 4 batch, three steps. Per-step loss within 1e-3·2.5^i relative,
  the budget of tests/test_convert_full.py. At this 64² size the
  trajectory is chaotic at the default lr of 1e-4: a 1e-6 relative
  perturbation of the weights moves the port's own step-2 loss by 2.7e-2,
  and the backbone gradients of the two float32 frameworks differ by ~2 %
  (as do the port's float32 and float64 ones). So the steps run at
  lr 1e-6, where that perturbation moves it by 9e-5. After the steps, the
  parameter and EMA updates (p − p0) agree to relative L2 0.25 (measured
  ≤ 0.11: Adam's first step is lr·sign(g), and ~1 % of the gradient's
  elements are below that 2 % noise) and BatchNorm statistics to atol
  2e-2 (measured ≤ 6e-3).
* BatchNorm running statistics after one step, which depend only on the
  first forward: rtol 1e-4, atol 1e-5 (measured ≤ 3e-5 absolute on values
  near 1, float32 activations after 50 layers in two frameworks). Torch's
  unbiased running variance is off by var/(n−1)·0.1, about 6e-3 here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from _torch_port import cfg_pair, random_batch
from zsgnet_tpu.convert.torch_import import convert_zsgnet_checkpoint
from zsgnet_tpu.models.zsgnet import anchor_pyramid_for as j_anchor_pyramid
from zsgnet_tpu.models.zsgnet import get_default_net as j_net
from zsgnet_tpu.ops.pallas.fused_loss import pack_anchors as j_pack, zsg_loss_fused as j_fused
from zsgnet_tpu.parallel import train_step as jts
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for
from zsgnet_tpu_torch.models.zsgnet import get_default_net as t_net
from zsgnet_tpu_torch.ops import anchors as t_anchors
from zsgnet_tpu_torch.ops.cuda import fused_loss as fl
from zsgnet_tpu_torch.parallel import train_step as tts

torch.set_num_threads(1)

VOCAB = 30
HEAD = ("head.conv0", "head.conv1", "head.conv2", "head.conv3", "head.out")


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --------------------------------------------------------------------- K2


def _loss_inputs(rng, b=8):
    """tests/test_pallas.py::_setup's inputs, with a zero-extent gt in row
    2, whose IoU ties at 0 over every anchor."""
    sizes = t_anchors.feature_map_sizes((64, 64), strides=(8, 16, 32))
    anchors = t_anchors.create_anchors((1.0, 1.26), (0.5, 1.0, 2.0), sizes)
    a = anchors.shape[0]
    att = rng.normal(size=(b, a)).astype(np.float32) * 2
    bbx = rng.normal(size=(b, a, 4)).astype(np.float32)
    gt = rng.uniform(-1, 1, size=(b, 4)).astype(np.float32)
    gt = np.concatenate(
        [np.minimum(gt[:, :2], gt[:, 2:]), np.maximum(gt[:, :2], gt[:, 2:]) + 0.05], axis=1
    )
    gt[2] = (0.3, 0.3, 0.3, 0.3)
    return anchors, att, bbx, gt


WEIGHTS = {"unweighted": None, "weighted": np.array([1, 0, 1, 1, 1, 0, 1, 1], np.float32)}


@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
def test_backward_reference_matches_autograd(weights):
    anchors, att, bbx, gt = _loss_inputs(np.random.default_rng(21))
    w = _t(np.ones(len(gt), np.float32) if WEIGHTS[weights] is None else WEIGHTS[weights])
    packed = fl.pack_anchors(anchors, "cpu")
    a, b = _t(att).requires_grad_(), _t(bbx).requires_grad_()
    sums = fl.fused_match_loss_reference(a, b, *packed, _t(gt), w)
    grad = torch.tensor([0.3, -1.7, 2.0])
    want = torch.autograd.grad(sums, (a, b), grad)
    got = fl.fused_match_loss_backward_reference(_t(att), _t(bbx), *packed, _t(gt), w, grad)
    for g, x in zip(got, want):
        assert g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), x.numpy(), atol=1e-6, rtol=0)
    assert float(got[1][2].abs().sum()) > 0  # the tie row's promoted anchor has a box gradient


@pytest.mark.parametrize("weights", list(WEIGHTS), ids=list(WEIGHTS))
def test_backward_matches_jax_pallas_vjp(weights, monkeypatch):
    anchors, att, bbx, gt = _loss_inputs(np.random.default_rng(22))
    w = WEIGHTS[weights]

    def j_total(att_, bbx_):
        return j_fused(att_, bbx_, jnp.asarray(j_pack(anchors)), jnp.asarray(gt),
                       num_anchors=anchors.shape[0], lamb_reg=1.5,
                       sample_weight=None if w is None else jnp.asarray(w))["total"]

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(j_total, argnums=(0, 1))(jnp.asarray(att), jnp.asarray(bbx))

    calls = []
    plain = fl.fused_match_loss_backward_reference
    monkeypatch.setattr(fl, "fused_match_loss_backward_reference",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    launches = fl.fused_match_loss_backward.launches
    a, b = _t(att).requires_grad_(), _t(bbx).requires_grad_()
    total = fl.zsg_loss_fused(a, b, fl.pack_anchors(anchors, "cpu"), _t(gt), lamb_reg=1.5,
                              sample_weight=None if w is None else _t(w))["total"]
    total.backward()
    assert calls == [1] and fl.fused_match_loss_backward.launches == launches
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)


def test_backward_kernel_by_name_refuses_cpu_tensors_and_unknown_names():
    anchors, att, bbx, gt = _loss_inputs(np.random.default_rng(23))
    args = (_t(att), _t(bbx), *fl.pack_anchors(anchors, "cpu"), _t(gt), torch.ones(len(gt)),
            torch.zeros(len(gt), dtype=torch.int32), torch.ones(3))
    with pytest.raises(ValueError, match="unknown K2 kernel"):
        fl.launch_bwd_variant("rows3", *args)
    with pytest.raises(ValueError, match="runs a CUDA kernel"):
        fl.launch_bwd_variant("elementwise", *args)


# --------------------------------------------------------------- schedule


@pytest.mark.parametrize("sched", [
    dict(),
    dict(warmup_steps=3),
    dict(lr_schedule="cosine", lr_decay_steps=10),
    dict(lr_schedule="cosine", warmup_steps=2, lr_decay_steps=9, lr_min_frac=0.1),
    dict(lr_schedule="linear", warmup_steps=4, lr_decay_steps=12, lr_min_frac=0.05),
], ids=["const", "warmup", "cosine", "cosine_warmup_floor", "linear_warmup_floor"])
def test_lr_schedule_matches_jax(sched):
    jcfg, tcfg = cfg_pair(**sched)
    for step in range(16):
        want = float(jts.lr_schedule_scale(jcfg, jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(tts.lr_schedule_scale(tcfg, step), want, rtol=1e-6, err_msg=step)


def test_lr_schedule_refuses_a_missing_horizon():
    _, tcfg = cfg_pair(lr_schedule="cosine", lr_decay_steps=0)
    with pytest.raises(ValueError, match="lr_decay_steps"):
        tts.make_train_step(tcfg, anchor_pyramid_for(tcfg), device="cpu")


# -------------------------------------------------------------- optimizer


@pytest.mark.parametrize("opt", [
    dict(),
    dict(weight_decay=1e-2, grad_clip=0.5),
    dict(opt_to_use="sgd", grad_clip=0.5),
], ids=["adam", "adamw_clip", "sgd_clip"])
def test_optimizer_matches_optax(opt):
    """make_optimizer + clip_by_global_norm_ + the host lr against the JAX
    step's optax chain times its update scale, on random tensors."""
    jcfg, tcfg = cfg_pair(lr=1e-2, **opt)
    rng = np.random.default_rng(23)
    p0 = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 0.4 for p in p0] for _ in range(3)]
    scales = (0.5, 1.0, 0.25)

    tx = jts.make_optimizer(jcfg)
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    for g, s in zip(grads, scales):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, [u * jnp.float32(s) for u in upd])

    tp = [torch.nn.Parameter(_t(p).clone()) for p in p0]
    opt_t = tts.make_optimizer(tcfg, tp)
    for g, s in zip(grads, scales):
        for p, x in zip(tp, g):
            p.grad = _t(x).clone()
        if tcfg.grad_clip > 0:
            tts.clip_by_global_norm_([p.grad for p in tp], tcfg.grad_clip)
        for group in opt_t.param_groups:
            group["lr"] = tcfg.lr * s
        opt_t.step()
    for p, want in zip(tp, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_adamw_decays_the_lstm_bias_as_optax():
    """One AdamW step (lr 1e-2, weight_decay 0.1) on the port's own init
    against optax's AdamW on the same weights carried to JAX by the JAX
    package's converter, the same gradient reaching torch's ``bias_ih`` and
    JAX's one bias: bias_ih + bias_hh equals JAX's bias within 1e-6
    (float32; a bias_hh of 0.1 left in the sum would differ by lr·wd·0.1)."""
    jcfg, tcfg = cfg_pair(lr=1e-2, weight_decay=0.1)
    model = t_net(tcfg, VOCAB, seed=1, device="cpu")
    variables = convert_zsgnet_checkpoint(model.state_dict(), head_conv_prefixes=HEAD,
                                          num_anchors=tcfg.num_anchors)
    qe = variables["params"]["query_enc"]
    rng = np.random.default_rng(26)
    dirs = {"fwd": "l0", "bwd": "l0_reverse"}
    grads = {d: rng.normal(size=np.shape(qe[d]["bias"])).astype(np.float32) for d in dirs}

    jparams = {d: jnp.asarray(qe[d]["bias"]) for d in dirs}
    tx = jts.make_optimizer(jcfg)
    upd, _ = tx.update({d: jnp.asarray(g) for d, g in grads.items()}, tx.init(jparams), jparams)
    want = optax.apply_updates(jparams, upd)

    lstm = model.lstm
    for sfx in dirs.values():
        assert float(getattr(lstm, f"bias_hh_{sfx}").abs().max()) == 0.0
    state = tts.create_train_state(tcfg, model)
    for d, sfx in dirs.items():
        getattr(lstm, f"bias_ih_{sfx}").grad = _t(grads[d]).clone()
    state.optimizer.step()
    for d, sfx in dirs.items():
        got = (getattr(lstm, f"bias_ih_{sfx}") + getattr(lstm, f"bias_hh_{sfx}")).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want[d]), atol=1e-6, rtol=0)


# -------------------------------------------------------------- the step

CASES = {
    "default": dict(),
    "grad_accum2": dict(grad_accum=2),
    "ema": dict(ema_decay=0.99),
    "cosine_warmup": dict(lr_schedule="cosine", warmup_steps=2, lr_decay_steps=4),
    "wd_clip": dict(weight_decay=1e-4, grad_clip=1.0),
    "sgd": dict(opt_to_use="sgd"),
}
STEPS = 3


def _to_jax(state_dict, cfg) -> dict:
    """A port state_dict as the JAX {"params", "batch_stats"} tree (numpy)."""
    conv = convert_zsgnet_checkpoint(state_dict, head_conv_prefixes=HEAD,
                                     num_anchors=cfg.num_anchors)
    return {c: traverse_util.flatten_dict(jax.tree.map(np.asarray, conv[c]))
            for c in ("params", "batch_stats")}


@functools.lru_cache(maxsize=None)
def _run(case: str) -> dict:
    """Both steps from the same weights on the same batch, STEPS times."""
    jcfg, tcfg = cfg_pair(bs=4, lr=1e-6, **CASES[case])
    init = t_net(tcfg, VOCAB, seed=1, device="cpu").state_dict()
    variables = jax.tree.map(np.asarray, convert_zsgnet_checkpoint(
        init, head_conv_prefixes=HEAD, num_anchors=tcfg.num_anchors))
    batch = random_batch(np.random.default_rng(24), 4, tcfg, VOCAB)

    tx = jts.make_optimizer(jcfg)
    jstate = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]),
        lr_scale=jnp.ones((), jnp.float32), tx=tx,
        apply_fn=j_net(jcfg, vocab_size=VOCAB).apply,
        ema_params=(jax.tree.map(jnp.copy, variables["params"]) if jcfg.ema_decay > 0 else None),
    )
    jstep = jts.make_train_step(jcfg, j_anchor_pyramid(jcfg), mesh=None)
    model = ZSGNet(tcfg, VOCAB)
    model.load_state_dict(state_dict_from_jax(variables, tcfg))
    tstate = tts.create_train_state(tcfg, model)
    tstep = tts.make_train_step(tcfg, anchor_pyramid_for(tcfg), device="cpu")

    out = {"jax_loss": [], "port_loss": [], "p0": _to_jax(init, tcfg)["params"]}
    for i in range(STEPS):
        jstate, jl = jstep(jstate, {k: batch[k] for k in ("img", "qvec", "qlens", "annot")})
        tstate, tl = tstep(tstate, batch)
        out["jax_loss"].append(float(jl["total"]))
        out["port_loss"].append(float(tl["total"]))
        if i == 0:
            out["jax_bn1"] = traverse_util.flatten_dict(jax.tree.map(np.asarray, jstate.batch_stats))
            out["port_bn1"] = _to_jax(model.state_dict(), tcfg)["batch_stats"]
    out["jax"] = {"params": traverse_util.flatten_dict(jax.tree.map(np.asarray, jstate.params)),
                  "batch_stats": traverse_util.flatten_dict(jax.tree.map(np.asarray, jstate.batch_stats))}
    out["port"] = _to_jax(model.state_dict(), tcfg)
    if tstate.ema is not None:
        out["jax_ema"] = traverse_util.flatten_dict(jax.tree.map(np.asarray, jstate.ema_params))
        out["port_ema"] = _to_jax({**model.state_dict(), **tstate.ema}, tcfg)["params"]
    out["port_steps"] = tstate.step
    return out


def _update_rel_l2(got: dict, want: dict, p0: dict) -> float:
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    return float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    r = _run(case)
    assert r["port_steps"] == STEPS
    for i, (j, t) in enumerate(zip(r["jax_loss"], r["port_loss"])):
        assert abs(j - t) / abs(j) <= 1e-3 * 2.5 ** i, (i, r["jax_loss"], r["port_loss"])
    assert r["jax_loss"][-1] < r["jax_loss"][0] and r["port_loss"][-1] < r["port_loss"][0]
    assert set(r["port"]["params"]) == set(r["jax"]["params"])
    assert _update_rel_l2(r["port"]["params"], r["jax"]["params"], r["p0"]) <= 0.25
    for k, want in r["jax"]["batch_stats"].items():
        np.testing.assert_allclose(r["port"]["batch_stats"][k], want, atol=2e-2, rtol=0, err_msg=str(k))
    if "jax_ema" in r:
        assert _update_rel_l2(r["port_ema"], r["jax_ema"], r["p0"]) <= 0.25


def test_bn_running_stats_after_one_step_match_jax():
    r = _run("default")
    assert set(r["port_bn1"]) == set(r["jax_bn1"])
    for k, want in r["jax_bn1"].items():
        np.testing.assert_allclose(r["port_bn1"][k], want, rtol=1e-4, atol=1e-5, err_msg=str(k))
