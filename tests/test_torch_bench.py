"""The port's headline benchmark (``zsgnet_tpu_torch.bench``) against the JAX
bench (``bench.py``) on the CPU at a small size (64², widths 16 and 8,
float32; the bench's vocab of 10000).

* ``make_batches`` draws the JAX bench's arrays byte for byte, in its order
  (the sequence of ``bench.py:76-84`` then ``:149-160`` written out here).
* ``infer`` on JAX variables carried across by ``state_dict_from_jax``
  agrees with the JAX ``model.apply`` and ``decode_best_box_levels``, flat
  and grouped: raw scores within atol 5e-4 / rtol 2e-3 (the budget of
  ``test_torch_model.py``), the same argmax anchors, boxes within 1e-3.
  The JAX decode averages tied maxima where the port takes the first; on
  random inputs no maxima tie, so the two decodes pick the same anchor.
* int8 after ``calibrate`` at ``calib@0.999``: the scales equal the JAX
  calibration's (rtol 1e-5); on the JAX scales, flat and grouped outputs
  equal the JAX int8 model's with identity BatchNorm (so the argmax too),
  and stay within twice the JAX int8−float gap (the budget of
  ``test_torch_quant.py``) with real BatchNorm statistics.
* ``run`` returns exactly the JAX bench's ten keys, times the paths in the
  JAX order on one calibration, and ``main`` prints the row last.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cfg_pair, jax_variables, port_model
from test_torch_quant import _identity_bn
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu.models.zsgnet import anchor_components_for
from zsgnet_tpu.ops.level_ops import decode_best_box_levels
from zsgnet_tpu_torch import bench
from zsgnet_tpu_torch.convert import quant_state_from_jax
from zsgnet_tpu_torch.models.quant import quant_scales
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for

torch.set_num_threads(1)

VOCAB = bench.VOCAB
B = 26  # the grouped batch's 26 images are the flat batch's first 26
KEYS = ("metric", "value", "unit", "vs_baseline", "int8_qps", "int8_vs_baseline", "grouped_q5_qps",
        "grouped_q5_vs_baseline", "grouped_q5_int8_qps", "grouped_q5_int8_vs_baseline")


def _jax_bench_draws(batch: int, h: int, w: int, t: int, vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    return [
        rng.integers(0, 255, size=(batch, h, w, 3)).astype(np.uint8),  # bench.py:76-78
        rng.integers(1, vocab, size=(batch, t)).astype(np.int32),  # :79-81
        rng.integers(3, 12, size=(batch,)).astype(np.int32),  # :82-84
        rng.integers(1, vocab, size=(26, 5, t)).astype(np.int32),  # :152-157
        rng.integers(3, 12, size=(26, 5)).astype(np.int32),  # :158-160
    ]


@pytest.mark.parametrize("size", ["small", "default"])
def test_make_batches_are_the_jax_bench_draws(size):
    cfg = cfg_pair(max_qlen=12)[1] if size == "small" else bench.bench_cfg()
    batch = 32 if size == "small" else bench.BATCH
    flat, grouped = bench.make_batches(cfg, batch)
    want = _jax_bench_draws(batch, *cfg.resize_img, cfg.max_qlen, 10000)
    got = [flat["img"], flat["qvec"], flat["qlens"], grouped["qvec"], grouped["qlens"]]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert grouped["img"].tobytes() == want[0][:26].tobytes()  # bench.py:151
    with pytest.raises(ValueError, match="fewer than"):
        bench.make_batches(cfg, 25)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = cfg_pair(max_qlen=12)
    variables = jax_variables(jcfg, VOCAB, seed=0)
    flat, grouped = bench.make_batches(tcfg, B)
    return jcfg, tcfg, variables, flat, grouped


@functools.lru_cache(maxsize=None)
def _jax_apply(jcfg):
    model = JZSGNet(cfg=jcfg, vocab_size=VOCAB)
    comps = anchor_components_for(jcfg)

    @jax.jit
    def run(variables, batch):
        out = model.apply(variables, batch, train=False)
        box, score = decode_best_box_levels(out["att_levels"], out["delta_levels"], comps)
        return box, score, out["att_out"], out["bbx_out"]

    return run


def _jax_infer(jcfg, variables, batch) -> list[np.ndarray]:
    return [np.asarray(x) for x in _jax_apply(jcfg)(variables, {k: jnp.asarray(v) for k, v in batch.items()})]


def _port_infer(model, tcfg, batch) -> list[np.ndarray]:
    anchors = torch.as_tensor(anchor_pyramid_for(tcfg))
    b = bench.to_device(batch, torch.device("cpu"))
    box, score = bench.infer(model, anchors, b["img"], b["qvec"], b["qlens"])
    with torch.no_grad():
        out = model(b["img"], b["qvec"], b["qlens"])
    return [box.numpy(), score.numpy(), out["att_out"].numpy(), out["bbx_out"].numpy()]


@pytest.mark.parametrize("which", ["flat", "grouped"])
def test_infer_matches_jax(which):
    jcfg, tcfg, variables, flat, grouped = _setup()
    batch = flat if which == "flat" else grouped
    j_box, j_score, j_att, _ = _jax_infer(jcfg, variables, batch)
    box, score, att, _ = _port_infer(port_model(tcfg, variables, VOCAB), tcfg, batch)
    n = B if which == "flat" else 26 * 5
    assert box.shape == (n, 4) and score.shape == (n,)
    np.testing.assert_allclose(score, j_score, atol=5e-4, rtol=2e-3)
    np.testing.assert_array_equal(att.argmax(1), j_att.argmax(1))
    np.testing.assert_allclose(box, j_box, atol=1e-3, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_calibration(jcfg, bn: str) -> dict:
    variables = _variables(bn)
    flat = _setup()[3]
    calib = JZSGNet(cfg=jcfg.replace(quant_mode=bench.CALIB), vocab_size=VOCAB)
    _, q = jax.jit(lambda v, b: calib.apply(v, b, train=False, mutable=["quant"]))(
        variables, {k: jnp.asarray(v) for k, v in flat.items()})
    return jax.tree.map(np.asarray, q["quant"])


@functools.lru_cache(maxsize=None)
def _variables(bn: str) -> dict:
    variables = _setup()[2]
    return _identity_bn(variables) if bn == "identity_bn" else variables


@functools.lru_cache(maxsize=None)
def _int8_setup(bn: str):
    """The port's model calibrated by ``bench.calibrate`` on the flat batch,
    and the JAX calibration of the same variables on the same batch."""
    jcfg, tcfg, _, flat, _ = _setup()
    model = port_model(tcfg.replace(quant_mode="int8"), _variables(bn), VOCAB)
    bench.calibrate(model, bench.to_device(flat, torch.device("cpu")))
    return model, _jax_calibration(jcfg, bn)


def test_bench_calibration_matches_jax():
    tcfg = _setup()[1]
    model, jq = _int8_setup("bn_stats")
    got, want = quant_scales(model), quant_state_from_jax(jq, tcfg)
    assert set(got) == set(want) and len(got) > 50
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert bench.quant_modes(model) == {"int8"}


@pytest.mark.parametrize("which", ["flat", "grouped"])
@pytest.mark.parametrize("bn", ["identity_bn", "bn_stats"])
def test_int8_infer_matches_jax(bn, which):
    """On the JAX scales. With identity BatchNorm both packages' float math
    is exact and the int32 sums are equal, so the outputs, scores and argmax
    anchors equal the un-jitted JAX model's bit for bit (on the first rows:
    eval-mode rows are independent), and the decoded boxes within 1e-6 (the
    two packages' ``exp`` may differ by an ulp). With real BatchNorm statistics,
    last-bit differences move values across int8 rounding boundaries and the
    flips cascade (here up to 0.07, as far as the JAX model jitted is from
    itself un-jitted): outputs and scores within twice the JAX int8−float
    gap. This random model's top two logits lie closer than that gap, so
    there the argmax is not held: it flips between the JAX model jitted and
    un-jitted too."""
    jcfg, tcfg, _, flat, grouped = _setup()
    batch = flat if which == "flat" else grouped
    variables = _variables(bn)
    model, jq = _int8_setup(bn)
    model.load_state_dict(quant_state_from_jax(jq, tcfg), strict=False)
    assert bench.quant_modes(model) == {"int8"}
    j8 = {**variables, "quant": jq}
    box, score, att, bbx = _port_infer(model, tcfg, batch)
    if bn == "identity_bn":
        head = {k: v[: 4 if which == "flat" else 2] for k, v in batch.items()}
        out = JZSGNet(cfg=jcfg.replace(quant_mode="int8"), vocab_size=VOCAB).apply(
            j8, {k: jnp.asarray(v) for k, v in head.items()}, train=False)
        n = head["qvec"].shape[0] * (5 if which == "grouped" else 1)
        j_box, j_score = decode_best_box_levels(out["att_levels"], out["delta_levels"], anchor_components_for(jcfg))
        for got, want in ((att, out["att_out"]), (bbx, out["bbx_out"]), (score, j_score)):
            np.testing.assert_array_equal(got[:n], np.asarray(want))
        np.testing.assert_allclose(box[:n], np.asarray(j_box), atol=1e-6, rtol=0)  # exp differs by an ulp
        return
    want = _jax_infer(jcfg.replace(quant_mode="int8"), j8, batch)
    j_float = _jax_infer(jcfg, variables, batch)
    budget = {k: 2 * np.abs(want[k] - j_float[k]).max() for k in (2, 3)}
    assert np.abs(att - want[2]).max() <= budget[2]
    assert np.abs(bbx - want[3]).max() <= budget[3]
    assert np.abs(score - want[1]).max() <= budget[2]
    assert np.isfinite(box).all() and np.abs(box).max() <= 1.0


def _small_cfg():
    return cfg_pair(max_qlen=12)[1]


def test_run_returns_the_jax_keys():
    row = bench.run(_small_cfg(), device="cpu", batch=B, iters=1, warmup=1)
    assert tuple(row) == KEYS
    assert row["metric"] == "grounding_queries_per_sec_per_chip" and row["unit"] == "qps"
    for k in KEYS[1:]:
        if k != "unit":
            assert isinstance(row[k], float) and row[k] > 0, k
    assert row["vs_baseline"] == round(row["value"] / bench.V100_REF_QPS, 3)


def test_run_times_the_paths_in_the_jax_order_on_one_calibration(monkeypatch):
    """bf16 first, then calibration and int8, grouped with every quantizable
    module back in "off", grouped int8 on the flat batch's scales."""
    calls, scales = [], []
    infer = bench.infer

    def spy(model, anchors, img, qvec, qlens, canvas=None):
        calls.append((tuple(sorted(bench.quant_modes(model))), qvec.dim()))
        scales.append({k: float(v) for k, v in quant_scales(model).items()})
        return infer(model, anchors, img, qvec, qlens, canvas)

    monkeypatch.setattr(bench, "infer", spy)
    report = {}
    bench.run(_small_cfg(), device="cpu", batch=B, iters=2, warmup=1, report=report)
    assert calls == [(("off",), 2)] * 3 + [(("int8",), 2)] * 3 + [(("off",), 3)] * 3 + [(("int8",), 3)] * 3
    assert not scales[0] and scales[3] and all(s == scales[3] for s in scales[3:])
    assert set(report) >= {"value", "int8", "grouped_q5", "grouped_q5_int8", "model", "flat", "grouped"}
    assert report["grouped_q5"]["out"][0].shape == (130, 4) and report["value"]["out"][0].shape == (B, 4)
    assert report["value"]["device_ms"] is None  # no card


def test_measure_is_pairs_times_iters_over_seconds(monkeypatch):
    ticks = iter([10.0, 12.5])
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(ticks))
    n = []
    qps, out = bench.measure(lambda: n.append(1) or (torch.ones(2),), 50, warmup=3, iters=10)
    assert len(n) == 13 and qps == 50 * 10 / 2.5 and float(out[0].sum()) == 2.0


def test_main_prints_the_row_last(monkeypatch, capsys):
    row = {k: 1.0 for k in KEYS}
    monkeypatch.setattr(bench, "run", lambda device: row)
    assert bench.main(["--device=cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row
