"""int8 serving in the port against the JAX package (64², float32,
fpn_ch/head_ch 16; SSD at 96²).

* ``quantize_sym`` rounds half to even and clips as the JAX one (exact);
  ``absmax_stat`` is ``jnp.quantile``'s linear interpolation (exact).
* The int32 sums of ``int8_conv2d`` on shared int8 inputs equal
  ``lax.conv_general_dilated(..., preferred_element_type=int32)`` exactly,
  at the model's conv shapes (the stem's K = 147, strided 1×1 and 3×3,
  SSD's dilated conv6, the head's N = 45 out conv, 1×1 maps); the padding
  that ``torch._int_mm`` needs on the card adds nothing.
* Calibrated scales (``calib`` and ``calib@0.999``) equal the JAX ``quant``
  collection to rtol 1e-5 (float32 activations of the two packages differ
  in the last bits), name for name.
* With the JAX scales, the int8 forward is bit-identical to the JAX one on
  SSD-VGG (no BatchNorm) and on the retina model with identity BatchNorm.
  With random BatchNorm statistics the two BatchNorms round differently in
  the last bit, a value on a rounding boundary then quantizes one step
  apart (±1), and such flips cascade through 50 layers. Both int8 models
  approximate the same float model, so the outputs stay within twice the
  JAX model's own int8-vs-float error, and pick the same anchor.
* The ``Grounder`` chooses head and format as the JAX one at batch sizes 8
  and 32, with and without ``quantize``; a JAX calibration carried by
  ``convert`` serves the JAX answers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_port import QUERIES, cfg_pair, jax_variables, port_model, random_batch
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu.models.quant import _quantize_sym as j_quantize_sym
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu.predict import Grounder as JGrounder
from zsgnet_tpu_torch.convert import quant_state_from_jax, state_dict_from_jax
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.models import quant
from zsgnet_tpu_torch.models.quant import QuantConv2d, quant_scales, set_quant_mode
from zsgnet_tpu_torch.predict import Grounder

torch.set_num_threads(1)

VOCAB = 30
KEYS = ("img", "qvec", "qlens")


def test_quantize_sym_rounds_half_to_even_as_jax():
    x = np.float32([-200.0, -127.5, -2.5, -1.5, -0.5, 0.0, 0.49, 0.5, 1.5, 2.5, 126.5, 127.5, 300.0])
    rng = np.random.default_rng(0)
    x = np.concatenate([x, rng.normal(0, 60, 1000).astype(np.float32)])
    scale = np.float32(0.73)
    got = quant.quantize_sym(torch.from_numpy(x), torch.tensor(scale))
    want = np.asarray(j_quantize_sym(jnp.asarray(x), jnp.asarray(scale)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(quant.quantize_sym(torch.from_numpy(x[:13]), torch.tensor(1.0)).numpy(),
                                  [-127, -127, -2, -2, 0, 0, 0, 0, 2, 2, 126, 127, 127])


@pytest.mark.parametrize("n,pct", [(1, 0.999), (7, 0.5), (1000, 0.999), (4097, 0.999), (5000, 1.0)])
def test_absmax_stat_is_jnp_quantile(n, pct):
    x = np.random.default_rng(n).standard_cauchy(n).astype(np.float32)
    got = float(quant.absmax_stat(torch.from_numpy(x), pct))
    a = jnp.abs(jnp.asarray(x))
    want = float(jnp.quantile(a, pct) if pct < 1.0 else jnp.max(a))
    assert got == want


# (N, C, H, W, O, kernel, stride, padding, dilation): the stem, a strided
# 3×3, a strided 1×1 downsample, SSD's dilated conv6, the head's out conv
# (N = 45), a 3×3 over a 1×1 map, a batch-1 3×3 level.
CONV_SHAPES = {
    "stem_k147": (2, 3, 19, 17, 16, 7, 2, 3, 1),
    "3x3_s2": (2, 16, 9, 11, 24, 3, 2, 1, 1),
    "1x1_s2": (2, 32, 9, 9, 64, 1, 2, 0, 1),
    "dilated_d6": (1, 8, 13, 13, 16, 3, 1, 6, 6),
    "head_out_n45": (2, 16, 8, 8, 45, 3, 1, 1, 1),
    "1x1_map": (3, 16, 1, 1, 16, 3, 1, 1, 1),
    "batch1_3x3_level": (1, 24, 3, 3, 16, 3, 1, 1, 1),
}


@pytest.mark.parametrize("name", list(CONV_SHAPES))
def test_int32_sums_equal_jax(name):
    n, c, h, w, o, k, s, p, d = CONV_SHAPES[name]
    rng = np.random.default_rng(len(name))
    x = rng.integers(-127, 128, (n, c, h, w)).astype(np.int8)
    wq = rng.integers(-127, 128, (o, c, k, k)).astype(np.int8)
    got = quant.int8_conv2d(torch.from_numpy(x), torch.from_numpy(wq), s, p, d)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(wq.transpose(2, 3, 1, 0)), (s, s), [(p, p), (p, p)],
        rhs_dilation=(d, d), dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    cols, _, _ = quant.im2col_int8(torch.from_numpy(x), (k, k), s, p, d)
    a, b = quant.pad_for_int_mm(cols, torch.from_numpy(wq.reshape(o, -1).T.copy()))
    assert a.shape[0] >= 32 and a.shape[0] % 8 == 0 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
    padded = quant.int8_matmul_reference(a, b)[: cols.shape[0], :o]
    np.testing.assert_array_equal(padded.numpy(), got.permute(0, 2, 3, 1).reshape(-1, o).numpy())


def test_quant_conv_off_is_conv2d_and_calibrated_int8_is_close():
    torch.manual_seed(0)
    ref = torch.nn.Conv2d(8, 16, 3, padding=1)
    conv = QuantConv2d(8, 16, 3, padding=1)
    conv.load_state_dict(ref.state_dict())
    x = torch.randn(2, 8, 9, 9) * 3
    with torch.no_grad():
        want = ref(x)
        assert torch.equal(conv(x), want)
        conv.mode = "calib"
        conv(x)
        assert float(conv.act_absmax_9x9) == float(x.abs().max())
        conv.mode = "int8"
        got = conv(x)
    err = (got - want).abs().max() / want.abs().max()
    assert err < 0.03
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_conv0_split_equals_the_unsplit_conv_in_float():
    _, tcfg = cfg_pair()
    from zsgnet_tpu_torch.models.zsgnet import PredictionHead

    torch.manual_seed(1)
    head = PredictionHead(16, tcfg.lang_dim, 16, 9)
    x = torch.randn(3, 16 + tcfg.lang_dim + 2, 5, 7)
    with torch.no_grad():
        got = head.conv0_split(x, lambda v, w: torch.nn.functional.conv2d(v, w, padding=1))
        want = head.conv0(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def _setup(mdl: str, seed: int = 1):
    """SSD-VGG at 96² (its smallest pyramid that keeps six maps) with a
    batch of 2, retina at 64² with 4."""
    kw = dict(mdl_to_use=mdl, resize_img=(96, 96)) if mdl == "ssd_vgg" else {}
    jcfg, tcfg = cfg_pair(**kw)
    variables = jax_variables(jcfg, VOCAB, seed=seed)
    batch = random_batch(np.random.default_rng(5), 2 if mdl == "ssd_vgg" else 4, tcfg, VOCAB)
    return jcfg, tcfg, variables, {k: batch[k] for k in KEYS}


def _jax_calibrate(jcfg, variables, batch, mode: str) -> dict:
    _, q = JZSGNet(cfg=jcfg.replace(quant_mode=mode), vocab_size=VOCAB).apply(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}, mutable=["quant"])
    return jax.tree.map(np.asarray, q["quant"])


def _port_forward(model, batch):
    with torch.no_grad():
        return model(*(torch.from_numpy(batch[k]) for k in KEYS))


@pytest.mark.parametrize("mdl", ["retina", "ssd_vgg"])
@pytest.mark.parametrize("mode", ["calib", "calib@0.999"])
def test_calibrated_scales_match_jax(mdl, mode):
    jcfg, tcfg, variables, batch = _setup(mdl)
    want = quant_state_from_jax(_jax_calibrate(jcfg, variables, batch, mode), tcfg)
    model = port_model(tcfg.replace(quant_mode="int8"), variables, VOCAB)
    set_quant_mode(model, mode)
    _port_forward(model, batch)
    got = quant_scales(model)
    assert set(got) == set(want) and len(got) > 50
    assert any("vis_absmax_" in k for k in got)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def _identity_bn(variables: dict) -> dict:
    """BatchNorm with scale 1, bias 0, mean 0 and var + eps = 1: both
    packages' float math through it is exact."""
    stats = traverse_util.flatten_dict(variables["batch_stats"])
    stats = {p: np.zeros_like(v) if p[-1] == "mean" else np.full_like(v, 1.0 - 1e-5) for p, v in stats.items()}
    params = traverse_util.flatten_dict(variables["params"])
    for p, v in params.items():
        if p[-2].startswith("bn") or p[-2] == "downsample_bn":
            params[p] = np.ones_like(v) if p[-1] == "scale" else np.zeros_like(v)
    return {"params": traverse_util.unflatten_dict(params), "batch_stats": traverse_util.unflatten_dict(stats)}


@pytest.mark.parametrize("case", ["ssd_vgg", "retina_identity_bn", "retina"])
def test_int8_forward_matches_jax(case):
    jcfg, tcfg, variables, batch = _setup("ssd_vgg" if case == "ssd_vgg" else "retina")
    if case == "retina_identity_bn":
        variables = _identity_bn(variables)
    scales = _jax_calibrate(jcfg, variables, batch, "calib")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = JZSGNet(cfg=jcfg.replace(quant_mode="int8"), vocab_size=VOCAB).apply({**variables, "quant": scales}, jb)
    got = _port_forward(port_model(tcfg.replace(quant_mode="int8"), {**variables, "quant": scales}, VOCAB), batch)
    if case != "retina":
        for k in ("att_out", "bbx_out"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        return
    j_float = JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(variables, jb)
    for k in ("att_out", "bbx_out"):
        budget = 2 * np.abs(np.asarray(want[k]) - np.asarray(j_float[k])).max()
        assert np.abs(got[k].numpy() - np.asarray(want[k])).max() <= budget, k
    np.testing.assert_array_equal(got["att_out"].numpy().argmax(1), np.asarray(want["att_out"]).argmax(1))


@pytest.mark.parametrize("bs", [8, 32])
@pytest.mark.parametrize("quantize", [False, True])
def test_grounder_mode_choice_matches_jax(bs, quantize, capsys):
    jcfg, tcfg = cfg_pair()
    vocab = Vocab.build(QUERIES)
    variables = jax_variables(jcfg, len(vocab), seed=2)
    jg = JGrounder(jcfg, JVocab.build(QUERIES), variables, batch_size=bs, quantize=quantize)
    j_msg = capsys.readouterr().out
    tg = Grounder(tcfg, vocab, state_dict_from_jax(variables, tcfg), batch_size=bs, quantize=quantize, device="cpu")
    t_msg = capsys.readouterr().out
    assert (tg.cfg.head_canvas, tg.cfg.quant_mode, tg.quantize) == (jg.cfg.head_canvas, jg.cfg.quant_mode, jg.quantize)
    assert tg.latency_canvas == (jg._infer_latency is not None)
    assert bool(t_msg) == bool(j_msg) == (quantize and bs <= 16)
    assert tg.cfg.head_canvas == (bs <= 16)
    assert tg.canvas_for(4) is (True if tg.latency_canvas else None)


def test_int8_grounder_calibrates_on_its_first_batch():
    _, tcfg = cfg_pair()
    vocab = Vocab.build(QUERIES)
    g = Grounder(tcfg, vocab, port_model(tcfg, jax_variables(cfg_pair()[0], len(vocab), seed=2),
                                         len(vocab)).state_dict(), batch_size=32, quantize=True, device="cpu")
    g.warmup()  # skipped: nothing calibrated yet
    assert not g.calibrated
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8) for _ in QUERIES]
    first = g.ground(images, QUERIES)
    scales = {k: v.clone() for k, v in quant_scales(g.model).items()}
    assert g.calibrated and all(np.isfinite(r["score"]) for r in first)
    assert g.ground(images, QUERIES) == first
    assert all(torch.equal(v, quant_scales(g.model)[k]) for k, v in scales.items())
    assert all(m.mode == "int8" for m in g.model.modules() if isinstance(m, QuantConv2d))


def test_jax_calibration_through_convert_serves_the_jax_answers():
    """SSD-VGG: the JAX Grounder's int8 answers, from its own calibration
    carried across by ``state_dict_from_jax``. Boxes within 5e-4 and scores
    within 5e-5: the JAX Grounder's jitted program fuses the dequantization
    (multiply-adds), which moves a value on a rounding boundary by one int8
    step, where the un-jitted JAX model above is bit-identical."""
    jcfg, tcfg, variables, _ = _setup("ssd_vgg")
    vocab = Vocab.build(QUERIES)
    variables = jax_variables(jcfg, len(vocab), seed=4)
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, (96, 96, 3)).astype(np.uint8) for _ in QUERIES[:2]]
    jg = JGrounder(jcfg, JVocab.build(QUERIES), variables, batch_size=32, quantize=True, bucket_sizes=(2,))
    want = jg.ground(images, QUERIES[:2])
    full = {**variables, "quant": jax.tree.map(np.asarray, jg.variables["quant"])}
    tg = Grounder(tcfg, vocab, state_dict_from_jax(full, tcfg), batch_size=32, quantize=True,
                  bucket_sizes=(2,), device="cpu")
    assert tg.calibrated
    got = tg.ground(images, QUERIES[:2])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["box_norm"], b["box_norm"], atol=5e-4)
        assert abs(a["score"] - b["score"]) < 5e-5
