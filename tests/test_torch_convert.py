"""Checkpoint migration into the port, against the JAX package:

* a reference-layout ``.pth`` (a trainer dict, DDP's ``module.`` prefixes)
  → ``python -m zsgnet_tpu_torch.convert`` → ``Grounder.from_checkpoint``
  equals a Grounder holding the model's own state dict; the same file
  through ``python -m zsgnet_tpu.convert`` and the JAX
  ``Grounder.from_checkpoint`` gives the same boxes;
* a JAX ``CheckpointManager`` save → ``tools/jax_ckpt_to_torch.py`` → the
  port's Grounder equals the JAX Grounder on the same directory, with and
  without ``ema_params``."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import QUERIES, cfg_pair, jax_variables
from zsgnet_tpu.convert.__main__ import main as j_convert_main
from zsgnet_tpu.predict import Grounder as JGrounder
from zsgnet_tpu.train.checkpoint import CheckpointManager as JCheckpointManager
from zsgnet_tpu_torch.convert import detect_layout, main as convert_main, state_dict_from_jax, unwrap_state_dict
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.predict import Grounder

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--lstm_dim=8", "--fpn_ch=16", "--head_ch=16", "--resize_img=[64,64]", "--max_qlen=8"]


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = cfg_pair()
    vocab = Vocab.build(QUERIES)
    variables = jax_variables(jcfg, len(vocab), seed=8)
    return jcfg, tcfg, vocab, variables, state_dict_from_jax(variables, tcfg)


def _images(n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8) for _ in range(n)]


def _close(got: list[dict], want: list[dict]) -> None:
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g["box_norm"], w["box_norm"], atol=1e-4)
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"], atol=1e-2)
        assert abs(g["score"] - w["score"]) < 1e-5


# The reference's own names, and the same weights under other prefixes.
RENAMED = {"backbone.encoder.": "net.body.", "backbone.fpn.": "net.pyramid.", "lstm.": "qenc.rnn.",
           "embedding.weight": "qenc.emb.weight", "head.out.": "fuse.att_reg_box.", "head.": "fuse."}


@pytest.mark.parametrize("layout", ["reference", "renamed"])
def test_pth_cli_serves_the_models_own_outputs(weights, tmp_path, capsys, layout):
    jcfg, tcfg, vocab, _, sd = weights
    names = dict(sd)
    if layout == "renamed":
        names = {}
        for k, v in sd.items():
            src = next(s for s in (*RENAMED, "") if k.startswith(s))
            names[(RENAMED[src] if src else "") + k[len(src):]] = v
    pth = tmp_path / "ref.pth"
    torch.save({"model_state_dict": {f"module.{k}": v for k, v in names.items()}, "epoch": 3}, pth)
    vocab.save(tmp_path / "vocab.json")
    assert detect_layout(unwrap_state_dict(torch.load(pth, weights_only=False)))["num_anchors"] == 9

    out = tmp_path / "port"
    report = convert_main([str(pth), str(out), f"--vocab={tmp_path / 'vocab.json'}", *FLAGS])
    text = capsys.readouterr().out
    assert "detected layout:" in text and "WARNING" not in text
    assert report["leaves_converted"] == report["leaves_total"] == len(sd)
    assert json.loads(text.strip().splitlines()[-1]) == report
    images, queries = _images(3), QUERIES[:3]
    got = Grounder.from_checkpoint(out, batch_size=2, device="cpu").ground(images, queries)
    own = Grounder(tcfg, Vocab.build(QUERIES), sd, batch_size=2, device="cpu").ground(images, queries)
    assert got == own

    if layout == "reference":
        j_out = tmp_path / "jax"
        j_convert_main([str(pth), str(j_out), f"--vocab={tmp_path / 'vocab.json'}", *FLAGS])
        capsys.readouterr()
        assert json.loads((j_out / "cfg.json").read_text()) == json.loads((out / "cfg.json").read_text())
        _close(got, JGrounder.from_checkpoint(j_out, batch_size=1).ground(images, queries))


def _bridge():
    spec = importlib.util.spec_from_file_location("jax_ckpt_to_torch", ROOT / "tools" / "jax_ckpt_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("ema", [False, True], ids=["params", "ema_params"])
def test_jax_checkpoint_bridge_serves_what_jax_serves(weights, tmp_path, ema):
    jcfg, _, vocab, variables, _ = weights
    d = tmp_path / "jax_run"
    payload = {"params": variables["params"], "batch_stats": variables["batch_stats"], "step": 7,
               "epoch": 2, "best_metric": 0.25}
    if ema:
        payload["ema_params"] = jax_variables(jcfg, len(vocab), seed=11)["params"]
    mngr = JCheckpointManager(d)
    mngr.save(7, payload)
    mngr.wait()
    (d / "cfg.json").write_text(jcfg.replace(vocab_size=len(vocab)).dumps())
    vocab.save(d / "vocab.json")

    written = _bridge().convert(d, tmp_path / "port")
    assert written.name == "step_7.pt"
    saved = torch.load(written, weights_only=True)
    assert ("ema" in saved) == ema and (saved["step"], saved["epoch"], saved["best_metric"]) == (7, 2, 0.25)
    if ema:
        assert "backbone.encoder.bn1.running_mean" not in saved["ema"]
    images, queries = _images(2), QUERIES[:2]
    got = Grounder.from_checkpoint(tmp_path / "port", batch_size=2, device="cpu").ground(images, queries)
    _close(got, JGrounder.from_checkpoint(d, batch_size=1).ground(images, queries))
