"""zsgnet_tpu_torch stands alone: it loads neither jax nor any module of
zsgnet_tpu, its entry points refuse a missing CUDA device instead of
falling back to the CPU, and its config copy reads what the JAX package's
config reads."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import zsgnet_tpu_torch
from zsgnet_tpu.config import get_default_cfg as jax_default_cfg
from zsgnet_tpu_torch.config import get_default_cfg, update_from_dict

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "zsgnet_tpu_torch"


def _modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PKG)], prefix="zsgnet_tpu_torch.")
    )


def test_import_loads_no_jax_and_no_jax_package():
    """A subprocess, since this test process has jax loaded already."""
    code = (
        "import importlib, sys\n"
        f"for m in {['zsgnet_tpu_torch', *_modules()]!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'zsgnet_tpu' or m.startswith('zsgnet_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(_modules()) >= 15


@pytest.mark.parametrize("path", [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert "zsgnet_tpu." not in text


def _entry_points():
    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.data.vocab import Vocab
    from zsgnet_tpu_torch.main import main_dist
    from zsgnet_tpu_torch.parallel.train_step import make_compute_loss, make_eval_step, make_train_step
    from zsgnet_tpu_torch.predict import Grounder
    from zsgnet_tpu_torch.tools.bench_bottleneck import bench
    from zsgnet_tpu_torch.tools.bench_loss import bench as bench_loss
    from zsgnet_tpu_torch.train.learner import Learner

    cfg = Config(resize_img=(64, 64), fpn_ch=16, head_ch=16, emb_dim=8, lstm_dim=8)
    anchors = anchor_pyramid_for(cfg)
    vocab = Vocab.build(["the red box"])
    return {
        "get_default_net": lambda: get_default_net(cfg, 10),
        "make_eval_step": lambda: make_eval_step(cfg, anchors),
        "make_compute_loss": lambda: make_compute_loss(cfg, anchors),
        "Grounder": lambda: Grounder(cfg, vocab, ZSGNet(cfg, len(vocab)).state_dict()),
        "make_train_step": lambda: make_train_step(cfg, anchors),
        "Learner": lambda: Learner("uid", None, cfg),
        "main_dist": lambda: main_dist("uid", ds_to_use="synthetic", data_dir="no_such_dir"),
        "bench_bottleneck": lambda: bench(2),
        "bench_loss": lambda: bench_loss(2),
    }


@pytest.mark.parametrize("name", ["get_default_net", "make_eval_step", "make_compute_loss", "Grounder",
                                  "make_train_step", "Learner", "main_dist", "bench_bottleneck",
                                  "bench_loss"])
def test_entry_points_raise_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_default_cfg_matches_jax_package():
    assert get_default_cfg().to_dict() == jax_default_cfg().to_dict()
    cfg = update_from_dict(get_default_cfg(), {"batch_size": "8", "match_thr": "0.6",
                                               "resize_img": "[96, 96]"})
    assert (cfg.bs, cfg.matching_threshold, cfg.resize_img) == (8, 0.6, (96, 96))
    assert zsgnet_tpu_torch.Config is type(cfg)
    assert cfg.lang_dim == 512 and cfg.num_anchors == 9
