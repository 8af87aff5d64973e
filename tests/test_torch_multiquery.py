"""Grouped multi-query batches and per-level heads in the port, against
the JAX package on the CPU (64², float32, fpn_ch/head_ch 16); the grouped
train step is in tests/test_torch_grouped_step.py.

* Forward on the same weights (``state_dict_from_jax``): per-level heads
  (retina, ``use_same_atb=False``) and grouped Q = 3 batches on both
  backbones, atol 5e-4 / rtol 2e-3 (tests/test_torch_model.py's budget).
* Grouped batches' keys all reach the device (``pair_valid`` included).
* ``GroupedDataset`` units, ``pair_valid`` and items bit-identical to the
  JAX package's on the same CSV, with and without epoch reseeding; grouped
  validation equal to flat validation record for record; ``Learner.fit``
  and the command line on ``configs/flickr30k_grouped.json`` end to end.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cfg_pair, grouped_batch, jax_variables, port_model, random_batch
from zsgnet_tpu.config import Config as JConfig
from zsgnet_tpu.data import dataset as j_dataset
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu_torch import main as t_main
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data import synthetic
from zsgnet_tpu_torch.data.dataset import GroupedDataset, ImgQuDataset, get_data
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.models.zsgnet import FOCAL_PRIOR_BIAS, ZSGNet, anchor_pyramid_for, init_weights
from zsgnet_tpu_torch.parallel import train_step as tts
from zsgnet_tpu_torch.train.learner import Learner

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 30
B, Q = 2, 3


def _forward_pair(jcfg, tcfg, batch, seed=0):
    variables = jax_variables(jcfg, VOCAB, seed=seed)
    apply = jax.jit(lambda v, b: JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(v, b, train=False))
    want = apply(variables, {k: jnp.asarray(batch[k]) for k in ("img", "qvec", "qlens")})
    model = port_model(tcfg, variables, VOCAB)
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
    return got, want, model


FORWARD = {
    "retina_per_level_heads": dict(use_same_atb=False),
    "retina_grouped": dict(queries_per_img=Q),
    "ssd_grouped": dict(mdl_to_use="ssd_vgg", queries_per_img=Q),
}


@pytest.mark.parametrize("case", list(FORWARD))
def test_forward_matches_jax(case):
    jcfg, tcfg = cfg_pair(**FORWARD[case])
    rng = np.random.default_rng(3)
    if tcfg.queries_per_img > 1:
        batch = grouped_batch(rng, tcfg, B, Q, VOCAB)
        n = B * Q
    else:
        batch = random_batch(rng, 3, tcfg, VOCAB)
        n = 3
    got, want, model = _forward_pair(jcfg, tcfg, batch)
    a = anchor_pyramid_for(tcfg).shape[0]
    assert got["att_out"].shape == (n, a) and got["bbx_out"].shape == (n, a, 4)
    assert got["feat_sizes"] == tuple(tuple(s) for s in want["feat_sizes"])
    np.testing.assert_allclose(got["att_out"].numpy(), np.asarray(want["att_out"]), atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(got["bbx_out"].numpy(), np.asarray(want["bbx_out"]), atol=5e-4, rtol=2e-3)
    if not tcfg.use_same_atb:
        assert not hasattr(model, "head") and len(model.heads) == 5


def test_grouped_forward_is_the_tiled_flat_forward():
    """The grouped forward equals the flat forward of every image repeated
    Q times, bit for bit on the CPU."""
    _, tcfg = cfg_pair(queries_per_img=Q)
    batch = grouped_batch(np.random.default_rng(4), tcfg, B, Q, VOCAB)
    model = init_weights(ZSGNet(tcfg, VOCAB), seed=2).eval()
    with torch.no_grad():
        g = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
        f = model(torch.from_numpy(np.repeat(batch["img"], Q, axis=0)),
                  torch.from_numpy(batch["qvec"].reshape(B * Q, -1)),
                  torch.from_numpy(batch["qlens"].reshape(-1)))
    np.testing.assert_allclose(g["att_out"].numpy(), f["att_out"].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g["bbx_out"].numpy(), f["bbx_out"].numpy(), rtol=1e-6, atol=1e-6)


def test_every_head_starts_at_the_focal_prior():
    _, tcfg = cfg_pair(use_same_atb=False)
    model = init_weights(ZSGNet(tcfg, VOCAB))
    for head in model.heads:
        assert torch.all(head.out.bias[0::5] == FOCAL_PRIOR_BIAS)
        assert torch.all(head.out.bias.reshape(-1, 5)[:, 1:] == 0)


def test_train_keys_reach_the_device():
    """Every key the train step reads survives ``to_device`` (a dropped
    ``pair_valid`` would train on wrap-repeats unmasked)."""
    _, tcfg = cfg_pair(queries_per_img=Q)
    batch = grouped_batch(np.random.default_rng(7), tcfg, B, Q, VOCAB)
    keys = tts.train_batch_keys(tcfg)
    assert "pair_valid" in keys
    moved = tts.to_device({k: batch[k] for k in keys}, torch.device("cpu"))
    assert set(moved) == set(keys)
    assert tts.train_batch_keys(tcfg.replace(queries_per_img=1)) == ("img", "qvec", "qlens", "annot")


# ------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def grouped_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("grouped")
    synthetic.generate(root, n_train=8, n_val=7, n_test=2, img_size=64, all_objects=True)
    return root


TINY = dict(ds_to_use="synthetic", nw=0, resize_img=(64, 64), max_qlen=8, lstm_dim=8, emb_dim=8,
            fpn_ch=16, head_ch=16, compute_dtype="float32", epochs=1, opt_to_use="sgd", lr=1e-3,
            log_every=1)


@pytest.mark.parametrize("reseed", [False, True], ids=["static", "reseeded"])
def test_grouped_dataset_matches_jax(grouped_root, reseed):
    kw = dict(TINY, data_dir=str(grouped_root), queries_per_img=3)
    csv = grouped_root / "synthetic" / "csv_dir" / "train.csv"
    img_dir = grouped_root / "synthetic" / "images"
    tcfg, jcfg = Config(**kw), JConfig(**kw)
    t_ds = ImgQuDataset(csv, img_dir, Vocab.build(["the red box"]), tcfg)
    j_ds = j_dataset.ImgQuDataset(csv, img_dir, JVocab.build(["the red box"]), jcfg)
    t = GroupedDataset(t_ds, t_ds.df["img_id"], 3, reseed=reseed)
    j = j_dataset.GroupedDataset(j_ds, j_ds.df["img_id"], 3, reseed=reseed)
    for epoch in (None, 0, 1, 1):
        if epoch is not None:
            t.reseed(epoch)
            j.reseed(epoch)
        assert t.units == j.units and t.n_real == j.n_real
        assert any(n < 3 for n in t.n_real) and any(n == 3 for n in t.n_real)
        for i in (0, len(t) - 1):
            got, want = t[i], j[i]
            assert set(got) == set(want)
            for k in want:
                if k != "img":  # the JAX item is normalized float, the port's uint8
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert sorted({i for u in t.units for i in u}) == list(range(len(t_ds)))
    if reseed:
        fresh = GroupedDataset(t_ds, t_ds.df["img_id"], 3, reseed=True)
        fresh.reseed(1)
        assert fresh.units == t.units  # a resumed run rebuilds the epoch's units


def test_grouped_loaders_and_mid_epoch_replay(grouped_root, tmp_path):
    cfg = Config(**TINY, data_dir=str(grouped_root), tmp_path=str(tmp_path), bs=2, queries_per_img=2)
    data = get_data(cfg)
    b = data.train_dl.first_batch()
    assert b["img"].shape == (2, 64, 64, 3) and b["qvec"].shape == (2, 2, 8)
    assert b["annot"].shape == (2, 2, 4) and b["pair_valid"].shape == (2, 2)
    vb = data.valid_dl.first_batch()
    assert vb["qvec"].ndim == 3 and "pair_valid" in vb and "valid" in vb

    def idxs(dl, epoch, start):
        dl.set_epoch(epoch)
        dl.start_batch = start
        return [x["idxs"].tolist() for x in dl]

    full = idxs(data.train_dl, 1, 0)
    again = get_data(cfg).train_dl  # a resumed process: fresh units, epoch 1, batch 2 on
    assert idxs(again, 1, 2) == full[2:]
    assert idxs(data.train_dl, 0, 0) != full


def test_grouped_validation_matches_flat(grouped_root, tmp_path):
    """Every real pair counted once: the same ids, IoUs and Acc as flat."""
    base = dict(TINY, data_dir=str(grouped_root), bs=4)
    cfg_f = Config(**base, tmp_path=str(tmp_path / "f"))
    cfg_g = Config(**base, tmp_path=str(tmp_path / "g"), queries_per_img=3)
    lf = Learner("gval_f", get_data(cfg_f), cfg_f, device="cpu")
    lg = Learner("gval_g", get_data(cfg_g), cfg_g, device="cpu")
    lg.model.load_state_dict(lf.model.state_dict())
    mf, mg = lf.validate(), lg.validate()
    assert mf["num_samples"] == mg["num_samples"] == len(lf.data.valid_dl.ds)
    assert (mg["Acc"], mg["MaxPos"]) == (mf["Acc"], mf["MaxPos"])
    np.testing.assert_allclose(mg["MeanIoU"], mf["MeanIoU"], rtol=1e-5)

    def records(learn, uid):
        rows = [json.loads(x) for x in (learn.pred_dir / f"{uid}_val.jsonl").read_text().splitlines()]
        assert len({r["id"] for r in rows}) == len(rows)
        return {r["id"]: r for r in rows}

    rf, rg = records(lf, "gval_f"), records(lg, "gval_g")
    assert set(rf) == set(rg)
    for i in rf:
        assert rf[i]["correct"] == rg[i]["correct"]
        np.testing.assert_allclose(rg[i]["iou"], rf[i]["iou"], rtol=1e-5, atol=1e-6)


def test_learner_fit_grouped(grouped_root, tmp_path):
    cfg = Config(**TINY, data_dir=str(grouped_root), tmp_path=str(tmp_path), bs=2, queries_per_img=2)
    learn = Learner("fit_g", get_data(cfg), cfg, device="cpu")
    learn.fit(1)
    row = json.loads((tmp_path / "logs" / "fit_g.jsonl").read_text().splitlines()[-1])
    assert row["step"] == len(learn.data.train_dl) and np.isfinite(row["train_total"])
    assert np.isfinite(row["val_loss"]) and row["val_num_samples"] == len(learn.data.valid_dl.ds.ds)
    assert row["qps"] > 0


def test_main_runs_the_grouped_preset(grouped_root, tmp_path, monkeypatch):
    """``main --cfg_file=configs/flickr30k_grouped.json`` at test size: the
    preset's grouping (Q = 5, wrap-repeats) reaches ``fit``."""
    monkeypatch.setattr("sys.argv", [
        "main", "g_cli", f"--cfg_file={ROOT / 'configs' / 'flickr30k_grouped.json'}", "--device=cpu",
        "--ds_to_use=synthetic", f"--data_dir={grouped_root}", f"--tmp_path={tmp_path}",
        "--resize_img=[64,64]", "--fpn_ch=16", "--head_ch=16", "--emb_dim=8", "--lstm_dim=8",
        "--max_qlen=8", "--bs=2", "--epochs=1", "--compute_dtype=float32", "--nw=0", "--log_every=1",
    ])
    t_main.main()
    cfg = json.loads((tmp_path / "models" / "g_cli" / "cfg.json").read_text())
    assert cfg["queries_per_img"] == 5 and cfg["ds_to_use"] == "synthetic"
    row = json.loads((tmp_path / "logs" / "g_cli.jsonl").read_text().splitlines()[-1])
    assert row["epoch"] == 0 and row["step"] >= 1 and np.isfinite(row["train_total"])
