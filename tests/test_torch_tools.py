"""The port's operator tools against the JAX package's: ``doctor`` (a
subprocess, as tests/test_doctor.py runs it), ``demo`` on the CPU at 32²
with its export, ``ckpt_info`` on the demo's checkpoint and artifact (its
element counts against the JAX model's ``params`` and ``batch_stats`` at
the same cfg) and on JAX-shaped directories, and ``viz`` (``draw_box``,
``annotate_image`` and ``_iou_xyxy`` pixel- and value-identical;
``gallery`` on converted weights giving the JAX records: IoU and score
within 1e-4, the same ranks)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from _torch_port import jax_variables
from zsgnet_tpu import viz as j_viz
from zsgnet_tpu.config import Config as JConfig
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu.predict import Grounder as JGrounder
from zsgnet_tpu_torch import ckpt_info, viz
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.demo import demo
from zsgnet_tpu_torch.predict import Grounder

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
# The demo's model at 32² (demo.py's Config): JAX and port alike.
DEMO_ARCH = dict(resize_img=(32, 32), max_qlen=8, lstm_dim=16, emb_dim=16, fpn_ch=32, head_ch=32,
                 compute_dtype="float32", use_level_path=False)


def _doctor(*args):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-m", "zsgnet_tpu_torch.doctor", *args],
                          capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


def test_doctor_passes_with_device_cpu():
    out = _doctor("--device=cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    for row in ("torch", "numpy", "PIL", "pandas", "config", "scratch dir", "cuda device",
                "smoke (256² bf16 matmul)", "native image pipeline", "tensorboardX"):
        assert row in out.stdout, f"missing doctor row {row!r}:\n{out.stdout}"
    assert "all required checks passed" in out.stdout and "Traceback" not in out.stderr


def test_doctor_fails_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _doctor("--timeout=30")
    assert out.returncode == 1, out.stdout + out.stderr
    assert "[ FAIL ] cuda device" in out.stdout and "no CUDA device" in out.stdout
    assert "REQUIRED CHECKS FAILED" in out.stdout and "Traceback" not in out.stderr


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("demo")
    metrics = demo(work, epochs=1, n_train=8, img_size=32, bs=4, device="cpu")
    return work, metrics


def test_demo_end_to_end_on_the_cpu(demo_run):
    work, metrics = demo_run
    assert {"Acc", "MaxPos", "MeanIoU", "loss"} <= set(metrics)
    assert metrics["box_drift"] < 2e-2
    assert (work / "artifact" / "export.json").exists()
    assert (work / "tmp" / "models" / "demo" / "cfg.json").exists()


def test_demo_refuses_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo(tmp_path)
    assert not any(tmp_path.iterdir())


@pytest.fixture(scope="module")
def jax_demo_variables(demo_run):
    """A JAX init of the demo's architecture, with the demo's vocab size."""
    vocab = Vocab.load(demo_run[0] / "tmp" / "models" / "demo" / "vocab.json")
    return jax_variables(JConfig(**DEMO_ARCH), len(vocab), seed=1), vocab


@pytest.mark.parametrize("sub", ["", "best"])
def test_ckpt_info_on_the_demo_checkpoint(demo_run, jax_demo_variables, sub):
    """Step and epoch of the run; parameter and BatchNorm-statistic counts
    of the JAX model's ``params`` and ``batch_stats`` at the same cfg. The
    port's nn.LSTM keeps a second bias (``bias_hh``, folded to zero) per
    direction that the JAX LSTM does not have: the one difference."""
    import jax

    info = ckpt_info.describe(demo_run[0] / "tmp" / "models" / "demo" / sub)
    assert info["latest_step"] == 2 and info["steps_on_disk"][-1] == 2
    assert info["epoch"] == 1 and info["epoch_batches"] == 0 and info["best_step"] == 2
    assert info["self_contained"] and info["cfg_non_default"]["fpn_ch"] == 32
    variables, _ = jax_demo_variables
    n = lambda tree: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))  # noqa: E731
    bias_hh = 2 * 4 * DEMO_ARCH["lstm_dim"]
    assert info["elements"]["params"] == n(variables["params"]) + bias_hh
    assert info["elements"]["batch_stats"] == n(variables["batch_stats"])
    # Adam's two moments of every trained parameter (bias_hh is not trained).
    assert info["elements"]["opt_state"] >= 2 * (info["elements"]["params"] - bias_hh)


def test_ckpt_info_on_the_demo_artifact(demo_run, capsys):
    art = demo_run[0] / "artifact"
    info = ckpt_info.describe(art)
    assert info["kind"].startswith("serving artifact (torch.export")
    assert info["platforms"] == ["cpu"] and info["buckets"] == [4] and not info["quantized"]
    assert list(info["programs"]) == ["cpu/serving_fn.pt2"]
    ckpt_info.main([str(art)])
    assert json.loads(capsys.readouterr().out)["version"] == 1


@pytest.mark.parametrize("layout", ["orbax", "stablehlo", "empty", "missing"])
def test_ckpt_info_names_jax_dirs_and_the_converter(tmp_path, layout):
    if layout == "orbax":
        (tmp_path / "12" / "default").mkdir(parents=True)
        match = "JAX package checkpoint.*tools/jax_ckpt_to_torch.py"
    elif layout == "stablehlo":
        (tmp_path / "export.json").write_text(json.dumps({"version": 2, "platforms": ["tpu"]}))
        match = "JAX package serving artifact.*tools/jax_ckpt_to_torch.py"
    elif layout == "empty":
        match = "no step_<N>.pt checkpoints"
    else:
        tmp_path = tmp_path / "nope"
        match = "no such directory"
    with pytest.raises(SystemExit, match=match):
        ckpt_info.describe(tmp_path)


BOXES = [(5, 6, 30, 20), (30, 20, 5, 6), (-10, -4, 12.6, 50), (0, 0, 63, 47), (40.4, 3.5, 40.6, 3.5)]


@pytest.mark.parametrize("thickness", [1, 3])
@pytest.mark.parametrize("box", BOXES)
def test_draw_box_pixel_identical(box, thickness):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(48, 64, 3)).astype(np.uint8)
    got = viz.draw_box(img.copy(), box, (1, 2, 3), thickness)
    np.testing.assert_array_equal(got, j_viz.draw_box(img.copy(), box, (1, 2, 3), thickness))
    assert not np.array_equal(got, img) or box[0] < -5


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8), np.zeros((4, 4, 3), np.float32)])
def test_draw_box_rejects_bad_input(bad):
    with pytest.raises(ValueError, match="HWC uint8"):
        viz.draw_box(bad, (0, 0, 1, 1))


@pytest.mark.parametrize("a,b", [((0, 0, 10, 10), (5, 5, 15, 15)), ((0, 0, 10, 10), (0, 0, 10, 10)),
                                 ((0, 0, 1, 1), (2, 2, 3, 3)), ((0, 0, 0, 0), (0, 0, 0, 0)),
                                 ((3.5, 1, 9.25, 7), (2, 0.5, 8, 6.75))])
def test_iou_xyxy_equals_jax(a, b):
    assert viz._iou_xyxy(a, b) == j_viz._iou_xyxy(a, b)


@pytest.mark.parametrize("source", ["array", "path"])
def test_annotate_image_pixel_identical(tmp_path, source):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(40, 56, 3)).astype(np.uint8)
    image = img
    if source == "path":
        image = tmp_path / "in.png"
        Image.fromarray(img).save(image)
    res = {"box_xyxy": [4.2, 7.0, 30.0, 33.3], "score": 0.625}
    got = viz.annotate_image(image, res, gt_box_xyxy=[1, 2, 20, 25], out_path=tmp_path / "t" / "p.png")
    want = j_viz.annotate_image(image, res, gt_box_xyxy=[1, 2, 20, 25], out_path=tmp_path / "j.png")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / "p.png")), want)


def test_gallery_on_converted_weights_equals_jax(tmp_path, jax_demo_variables):
    """Random 32² images and the demo vocab's queries through the JAX
    Grounder and the port's on the same (converted) weights."""
    variables, vocab = jax_demo_variables
    rng = np.random.default_rng(4)
    root = tmp_path / "ds"
    (root / "images").mkdir(parents=True)
    (root / "csv_dir").mkdir()
    rows = []
    words = sorted(w for w in vocab.word_to_id if not w.startswith("<"))
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)).save(root / "images" / f"{i}.png")
        x1, y1 = rng.integers(0, 16, size=2)
        rows.append({"img_id": f"{i}.png", "x1": x1, "y1": y1, "x2": x1 + rng.integers(8, 16),
                     "y2": y1 + rng.integers(8, 16), "query": " ".join(rng.choice(words, size=3))})
    pd.DataFrame(rows).to_csv(root / "csv_dir" / "val.csv", index=False)
    jcfg, tcfg = JConfig(**DEMO_ARCH), Config(**DEMO_ARCH)
    vocab.save(tmp_path / "vocab.json")
    jg = JGrounder(jcfg, JVocab.load(tmp_path / "vocab.json"), variables, batch_size=4)
    tg = Grounder(tcfg, vocab, state_dict_from_jax(variables, tcfg), batch_size=4, device="cpu")
    want = j_viz.gallery(jg, root / "csv_dir" / "val.csv", tmp_path / "j", n=6)
    got = viz.gallery(tg, root / "csv_dir" / "val.csv", tmp_path / "t", n=6)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g["row"], g["img_id"], g["query"], g["gt_xyxy"]) == (w["row"], w["img_id"], w["query"], w["gt_xyxy"])
        assert abs(g["iou"] - w["iou"]) < 1e-4 and abs(g["score"] - w["score"]) < 1e-4
    rank = lambda recs: {r["row"]: int(Path(r["png"]).name[:3]) for r in recs}  # noqa: E731
    assert rank(got) == rank(want)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(Path(r["png"]).name for r in got)
