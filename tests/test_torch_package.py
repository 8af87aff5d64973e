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


def test_serving_modules_load_no_jax():
    code = (
        "import sys\n"
        "import zsgnet_tpu_torch.serve, zsgnet_tpu_torch.predict, zsgnet_tpu_torch.export\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'zsgnet_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SOURCES = [*sorted(PKG.rglob("*.py")), ROOT / "chip_smoke.py"]


def test_source_scan_covers_the_serving_modules():
    assert {PKG / "serve.py", PKG / "predict.py", PKG / "convert.py", PKG / "export.py",
            PKG / "data" / "embeddings.py", PKG / "models" / "canvas.py", PKG / "models" / "quant.py",
            *(PKG / "data" / "prep" / f"{m}.py"
              for m in ("__init__", "flickr30k", "referit", "visual_genome", "zero_shot_splits"))} <= set(SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert "zsgnet_tpu." not in text


def _entry_points():
    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.data.vocab import Vocab
    from zsgnet_tpu_torch.export import ExportedGrounder
    from zsgnet_tpu_torch.export import main as export_main
    from zsgnet_tpu_torch.main import main_dist
    from zsgnet_tpu_torch.parallel.train_step import make_compute_loss, make_eval_step, make_train_step
    from zsgnet_tpu_torch.predict import Grounder
    from zsgnet_tpu_torch.predict import main as predict_main
    from zsgnet_tpu_torch.serve import load_server_model
    from zsgnet_tpu_torch.serve import main as serve_main
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
        "Grounder.from_checkpoint": lambda: Grounder.from_checkpoint("no_such_dir"),
        "load_server_model": lambda: load_server_model("no_such_dir"),
        "serve.main": lambda: serve_main(["no_such_dir", "--port=0"]),
        "predict.main": lambda: predict_main(["no_such_dir", "no_such.png", "the red box"]),
        "export.main": lambda: export_main(["no_such_dir", "no_such_out"]),
        "ExportedGrounder.load": lambda: ExportedGrounder.load("no_such_dir"),
    }


@pytest.mark.parametrize("name", ["get_default_net", "make_eval_step", "make_compute_loss", "Grounder",
                                  "make_train_step", "Learner", "main_dist", "bench_bottleneck",
                                  "bench_loss", "Grounder.from_checkpoint", "load_server_model",
                                  "serve.main", "predict.main", "export.main", "ExportedGrounder.load"])
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


VARIANTS = {
    "remat_backbone": dict(remat_backbone=True),
    "queries_per_img": dict(queries_per_img=3, bs=2),
    "ssd_vgg": dict(mdl_to_use="ssd_vgg"),
    "ssd_vgg_uniform_proj": dict(mdl_to_use="ssd_vgg", ssd_uniform_proj=True),
    "use_same_atb_false": dict(use_same_atb=False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variants_are_no_longer_refused(variant):
    """The model and training variants the first slices refused build and
    step on the CPU."""
    import numpy as np

    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for, get_default_net
    from zsgnet_tpu_torch.parallel.train_step import check_supported, create_train_state, make_train_step

    cfg = Config(resize_img=(64, 64), fpn_ch=16, head_ch=16, emb_dim=8, lstm_dim=8, max_qlen=6,
                 compute_dtype="float32", **VARIANTS[variant])
    check_supported(cfg)
    model = get_default_net(cfg, 10, device="cpu")
    step = make_train_step(cfg, anchor_pyramid_for(cfg), device="cpu")
    rng = np.random.default_rng(0)
    q = (cfg.queries_per_img,) if cfg.queries_per_img > 1 else ()
    batch = {
        "img": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
        "qvec": rng.integers(1, 10, (2, *q, 6)).astype(np.int32),
        "qlens": np.full((2, *q), 4, np.int32),
        "annot": np.broadcast_to(np.float32([-0.5, -0.5, 0.5, 0.5]), (2, *q, 4)).copy(),
        "pair_valid": np.ones((2, *q), bool),
    }
    _, ls = step(create_train_state(cfg, model), batch)
    assert torch.isfinite(ls["total"])


def test_unported_options_still_raise_with_their_item(tmp_path, monkeypatch):
    """What the port does not run yet names its ROADMAP.md queue 1 item:
    spatial partitioning 4, data parallel and multi-host 3. The serving
    formats of item 2 (canvas head, int8, exported artifacts) serve."""
    from zsgnet_tpu_torch import main as t_main
    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.parallel.train_step import check_supported
    from zsgnet_tpu_torch.predict import check_servable
    from zsgnet_tpu_torch.serve import load_server_model

    cases = [
        (lambda: check_supported(Config(mesh_spatial=2)), "queue 1 item 4"),
        (lambda: check_servable(Config(mesh_spatial=2)), "queue 1 item 4"),
        (lambda: load_server_model(tmp_path / "ckpt", data_parallel=True, device="cpu"), "queue 1 item 3"),
    ]
    check_servable(Config(head_canvas=True, quant_mode="int8"))
    for fn, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            fn()
    monkeypatch.setattr("sys.argv", ["main", "run1", "--multi_host=True", "--device=cpu"])
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        t_main.main()
