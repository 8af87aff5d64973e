"""The port's ``Grounder`` against the JAX ``Grounder`` on the same weights
and random (non-constant) images: boxes to 1e-4 normalized (1e-2 pixels),
scores to 1e-5, one result per request, across a chunk boundary and over
the shape buckets 1, 2 and 4; ``ground_image`` against the JAX one and
against the port's own tiled ``ground``. The JAX Grounder at batch 4
serves through its canvas head, an exact reparameterization of the port's
per-level head, so the two agree to float32 tolerance. Flat decode (the
port) and the JAX per-level decode differ only on tied scores, which
random images do not produce. Then ``from_checkpoint`` on a run directory
the port's Learner wrote (EMA weights served), ``batch_predict`` and the
CLI."""

import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import QUERIES, cfg_pair, jax_variables
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu.predict import Grounder as JGrounder
from zsgnet_tpu_torch import predict
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data import synthetic
from zsgnet_tpu_torch.data.dataset import get_data
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.predict import Grounder, batch_predict, chunk_results, prep_chunk
from zsgnet_tpu_torch.train.checkpoint import CheckpointManager
from zsgnet_tpu_torch.train.learner import Learner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grounders():
    jcfg, tcfg = cfg_pair()
    vocab = Vocab.build(QUERIES)
    variables = jax_variables(jcfg, len(vocab), seed=2)
    jg = JGrounder(jcfg, JVocab.build(QUERIES), variables, batch_size=4, bucket_sizes=(1, 2, 4))
    tg = Grounder(tcfg, vocab, state_dict_from_jax(variables, tcfg), batch_size=4, device="cpu")
    return jg, tg


def _images(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8) for _ in range(n)]


def assert_results_close(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box_norm"], w["box_norm"], atol=1e-4)
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"], atol=1e-2)
        assert abs(g["score"] - w["score"]) < 1e-5


def test_ground_matches_jax(grounders):
    jg, tg = grounders
    rng = np.random.default_rng(13)
    images = [rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8) for _ in QUERIES]
    queries = QUERIES[::-1]
    got = tg.ground(images, queries)
    want = jg.ground(images, queries)
    assert len(got) == len(want) == len(QUERIES)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box_norm"], w["box_norm"], atol=1e-4)
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"], atol=1e-2)
        assert abs(g["score"] - w["score"]) < 1e-5
        assert np.all(np.abs(g["box_norm"]) <= 1.0)


def test_ground_from_image_files(grounders, tmp_path):
    """Paths decode with PIL at their original size; pixel boxes use it."""
    from PIL import Image

    _, tg = grounders
    rng = np.random.default_rng(14)
    arr = rng.integers(0, 256, size=(48, 80, 3)).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.png")
    (res,) = tg.ground([tmp_path / "a.png"], ["the red box"])
    y1, x1, y2, x2 = res["box_norm"]
    np.testing.assert_allclose(res["box_xyxy"], [(x1 + 1) * 40, (y1 + 1) * 24,
                                                 (x2 + 1) * 40, (y2 + 1) * 24], rtol=1e-6)
    assert tg.ground([], []) == []
    with pytest.raises(ValueError, match="pair up"):
        tg.ground([arr], [])


def test_prep_chunk_pads_with_length_one_rows():
    _, tcfg = cfg_pair()
    vocab = Vocab.build(QUERIES)
    img = np.full((64, 64, 3), 7, np.uint8)
    imgs, qvec, qlens, sizes, k = prep_chunk(tcfg, vocab, 4, [img], ["the red box"])
    assert k == 1 and imgs.shape == (4, 64, 64, 3) and qlens.tolist() == [3, 1, 1, 1]
    assert (imgs[1:] == 0).all() and (qvec[1:] == 0).all()
    res = chunk_results(np.zeros((4, 4)), np.full(4, 0.5), sizes, k)
    assert res == [{"box_norm": [0.0] * 4, "box_xyxy": [32.0] * 4, "score": 0.5}]


def test_buckets_match_jax(grounders):
    """1, 2, 3 and 6 requests pad to the buckets 1, 2, 4 and 4 + 2, as the
    JAX Grounder's do; the results equal the JAX ones and those of a port
    Grounder that pads every chunk to the full batch."""
    jg, tg = grounders
    assert tg.bucket_sizes == jg.bucket_sizes == (1, 2, 4)
    full = Grounder(tg.cfg, tg.vocab, tg.model.state_dict(), batch_size=4, bucket_sizes=(4,),
                    device="cpu")
    assert full.bucket_sizes == (4,)
    assert Grounder(tg.cfg, tg.vocab, tg.model.state_dict(), batch_size=32,
                    device="cpu").bucket_sizes == (1, 2, 4, 8, 16, 32)
    images = _images(21, 6)
    queries = (QUERIES * 2)[:6]
    for n in (1, 2, 3, 6):
        got = tg.ground(images[:n], queries[:n])
        assert_results_close(got, jg.ground(images[:n], queries[:n]))
        assert_results_close(got, full.ground(images[:n], queries[:n]))


def test_ground_image_matches_jax_and_tiled_ground(grounders):
    """Five queries against one image (chunks of 4 and 1): one backbone
    pass a chunk, equal to the JAX ground_image and to the tiled pairs."""
    jg, tg = grounders
    (img,) = _images(22, 1)
    got = tg.ground_image(img, QUERIES)
    assert_results_close(got, jg.ground_image(img, QUERIES))
    assert_results_close(got, tg.ground([img] * len(QUERIES), QUERIES))
    assert tg.ground_image(img, []) == []
    tg.warmup(multiquery=True)
    assert_results_close(tg.ground_image(img, QUERIES[:2]), got[:2])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory written by the port's Learner: one epoch with an EMA
    of the parameters, so its checkpoints carry ``ema``."""
    root = tmp_path_factory.mktemp("predict_data")
    synthetic.generate(root, n_train=8, n_val=4, n_test=4, img_size=64)
    cfg = Config(ds_to_use="synthetic", data_dir=str(root), tmp_path=str(root / "tmp"), bs=4, nw=1,
                 lr=1e-2, resize_img=(64, 64), max_qlen=8, lstm_dim=8, emb_dim=8, fpn_ch=16,
                 head_ch=16, compute_dtype="float32", ema_decay=0.5, seed=1)
    learn = Learner("serve_me", get_data(cfg), cfg, device="cpu")
    learn.fit(1)
    return SimpleNamespace(dir=learn.model_dir, cfg=cfg, vocab=learn.data.vocab,
                           image=root / "synthetic" / "images" / "val_00008.png")


def test_from_checkpoint_serves_the_ema_weights(run_dir):
    d = run_dir.dir
    (img,) = _images(23, 1)
    queries = ["the red box", "a blue zebra", "green"]
    for store in (d, d / "best"):
        payload = CheckpointManager(store).restore()
        assert set(payload["ema"]) < set(payload["model"])
        sd = {**payload["model"], **payload["ema"]}  # EMA parameters, saved BN statistics
        by_hand = Grounder(run_dir.cfg, run_dir.vocab, sd, batch_size=2, device="cpu")
        g = Grounder.from_checkpoint(store, batch_size=2, device="cpu")
        # batch_size 2 serves through the canvas head, as the JAX Grounder does
        assert g.cfg == run_dir.cfg.replace(vocab_size=len(run_dir.vocab), head_canvas=True)
        assert g.vocab.word_to_id == run_dir.vocab.word_to_id
        got = g.ground([img] * 3, queries)
        assert got == by_hand.ground([img] * 3, queries)
        raw = Grounder(run_dir.cfg, run_dir.vocab, payload["model"], batch_size=2, device="cpu")
        assert got != raw.ground([img] * 3, queries)


def test_from_checkpoint_overrides_and_missing_vocab(run_dir, tmp_path):
    g = Grounder.from_checkpoint(run_dir.dir, cfg_overrides={"max_qlen": "4", "bs": 2},
                                 batch_size=1, device="cpu")
    assert (g.cfg.max_qlen, g.cfg.bs, g.bucket_sizes) == (4, 2, (1,))
    g = Grounder.from_checkpoint(run_dir.dir, cfg=run_dir.cfg.replace(max_qlen=3), device="cpu")
    assert g.cfg.max_qlen == 3 and g.cfg.vocab_size == 0
    bare = tmp_path / "bare"
    bare.mkdir()
    for p in run_dir.dir.glob("step_*.pt"):
        shutil.copy(p, bare)
    shutil.copy(run_dir.dir / "cfg.json", bare)
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        Grounder.from_checkpoint(bare, device="cpu")
    shutil.copy(run_dir.dir / "vocab.json", tmp_path / "v.json")
    assert Grounder.from_checkpoint(bare, vocab_path=tmp_path / "v.json", device="cpu").bs == 8
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 4"):
        Grounder(run_dir.cfg.replace(mesh_spatial=2), run_dir.vocab, {}, device="cpu")
    g = Grounder.from_checkpoint(run_dir.dir, cfg_overrides={"quant_mode": "int8"}, batch_size=32, device="cpu")
    assert g.quantize and g.cfg.quant_mode == "int8" and not g.cfg.head_canvas and not g.calibrated
    g = Grounder.from_checkpoint(run_dir.dir, cfg_overrides={"quant_mode": "int8"}, device="cpu")
    assert not g.quantize and g.cfg.quant_mode == "off" and g.cfg.head_canvas


def test_batch_predict_grouped_matches_flat(grounders, tmp_path):
    """Multi-phrase images go through ground_image, single-phrase rows batch
    flat; rows come out in CSV order, equal to the all-flat path."""
    _, tg = grounders
    rng = np.random.default_rng(3)
    for name, hw in (("a.png", (48, 80)), ("b.png", (40, 64))):
        Image.fromarray(rng.integers(0, 255, (*hw, 3)).astype(np.uint8)).save(tmp_path / name)
    csv = tmp_path / "mix.csv"
    csv.write_text(
        "img_id,query,x1,y1,x2,y2\n"
        "a.png,the red box,0,0,1,1\n"
        "b.png,a blue ellipse,0,0,1,1\n"
        "a.png,a blue ellipse,0,0,1,1\n"
        "a.png,box on the left,0,0,1,1\n"
        "a.png,the left thing,0,0,1,1\n"
    )
    assert batch_predict(tg, csv, tmp_path, tmp_path / "g.jsonl", block_batches=1, grouped=True) == 5
    assert batch_predict(tg, csv, tmp_path, tmp_path / "f.jsonl", grouped=False) == 5
    got = [json.loads(x) for x in (tmp_path / "g.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in (tmp_path / "f.jsonl").read_text().splitlines()]
    assert [(r["img_id"], r["query"]) for r in got] == [(r["img_id"], r["query"]) for r in want]
    assert [r["query"] for r in got][:2] == ["the red box", "a blue ellipse"]
    assert_results_close(got, want)
    (direct,) = tg.ground([tmp_path / "a.png"], ["the red box"])
    assert_results_close(got[:1], [direct])
    bad = tmp_path / "bad.csv"
    bad.write_text("image,text\nx.png,hi\n")
    with pytest.raises(ValueError, match="missing columns"):
        batch_predict(tg, bad, tmp_path, tmp_path / "x.jsonl")


def test_cli_grounds_one_image_and_a_csv(run_dir, tmp_path, capsys):
    predict.main([str(run_dir.dir), str(run_dir.image), "the red box", "--device=cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    (want,) = Grounder.from_checkpoint(run_dir.dir, batch_size=1, device="cpu").ground(
        [run_dir.image], ["the red box"])
    x1, y1, x2, y2 = want["box_xyxy"]
    assert line == f"{x1:.1f} {y1:.1f} {x2:.1f} {y2:.1f}  score={want['score']:.4f}"
    csv_dir = run_dir.image.parent.parent / "csv_dir"
    out = tmp_path / "p.jsonl"
    predict.main([str(run_dir.dir / "best"), f"--csv={csv_dir / 'val.csv'}", "--batch_size=2",
                  f"--img_dir={run_dir.image.parent}", f"--out={out}", "--device=cpu"])
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(rows) == 4 and rows[0]["img_id"] == "val_00008.png"
    assert_results_close(rows[:1], Grounder.from_checkpoint(run_dir.dir, device="cpu").ground(
        [run_dir.image], [rows[0]["query"]]))
    predict.main([str(run_dir.dir), str(run_dir.image), "the red box", "--quantize=true", "--device=cpu"])
    ignored, line_q = capsys.readouterr().out.strip().splitlines()[-2:]
    assert "quantize=True ignored" in ignored and line_q == line
    predict.main([str(run_dir.dir), f"--csv={csv_dir / 'val.csv'}", "--batch_size=32", "--quantize=true",
                  f"--img_dir={run_dir.image.parent}", f"--out={out}", "--device=cpu"])
    rows_q = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["query"] for r in rows_q] == [r["query"] for r in rows]
    assert all(np.isfinite(r["score"]) and np.abs(r["box_norm"]).max() <= 1.0 for r in rows_q)
