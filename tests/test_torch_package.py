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


SOURCES = [*sorted(PKG.rglob("*.py")), PKG / "csrc" / "zsg_image.cpp", ROOT / "chip_smoke.py"]


def test_source_scan_covers_the_serving_modules():
    assert {PKG / "serve.py", PKG / "predict.py", PKG / "convert.py", PKG / "export.py",
            PKG / "data" / "embeddings.py", PKG / "models" / "canvas.py", PKG / "models" / "quant.py",
            *(PKG / "data" / "prep" / f"{m}.py"
              for m in ("__init__", "flickr30k", "referit", "visual_genome", "zero_shot_splits"))} <= set(SOURCES)


def test_source_scan_covers_the_host_data_path_and_the_tools():
    assert {PKG / "data" / "native.py", PKG / "data" / "packed.py", PKG / "utils" / "profiling.py",
            PKG / "utils" / "debug.py", PKG / "csrc" / "zsg_image.cpp",
            *(PKG / f"{m}.py" for m in ("ckpt_info", "doctor", "demo", "viz"))} <= set(SOURCES)


def test_native_library_builds_from_the_ports_own_source():
    """The port compiles its own copy of the host decoder into build/native
    and never loads the JAX package's csrc/libzsgimage.so."""
    from zsgnet_tpu_torch.data import native

    assert native.SOURCE == PKG / "csrc" / "zsg_image.cpp"
    assert native.BUILD_DIR == ROOT / "build" / "native"
    cmd = native.build_command(native.lib_path())
    assert str(native.SOURCE) in cmd and not any(str(ROOT / "csrc") in a for a in cmd)
    text = (PKG / "data" / "native.py").read_text()
    assert "libzsgimage.so" not in text.replace('f"libzsgimage-', "") and "Makefile" not in text


BENCH_SOURCES = [PKG / "bench.py", *(PKG / "tools" / f"{m}.py" for m in
                                      ("profile_bench", "bench_infer_ab", "bench_grouped_train", "profile_train_step"))]


def test_source_scan_covers_the_bench_and_the_measurement_tools():
    """The headline bench and its tools are scanned, and none of them loads
    the root ``bench.py`` (the JAX bench)."""
    assert set(BENCH_SOURCES) <= set(SOURCES)
    for path in BENCH_SOURCES:
        assert not re.search(r"^\s*(import|from)\s+bench\b", path.read_text(), re.M), path


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
    from zsgnet_tpu_torch.demo import demo
    from zsgnet_tpu_torch.viz import main as viz_main
    from zsgnet_tpu_torch import bench as headline
    from zsgnet_tpu_torch.tools import bench_grouped_train, bench_infer_ab, profile_bench, profile_train_step

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
        "demo": lambda: demo("no_such_dir"),
        "viz.main": lambda: viz_main(["no_such_dir", "--csv=no_such.csv"]),
        "bench.main": lambda: headline.main([]),
        "bench.run": lambda: headline.run(cfg),
        "profile_bench": lambda: profile_bench.bench(2, cfg=cfg),
        "bench_infer_ab": lambda: bench_infer_ab.bench(2, cfg=cfg),
        "bench_grouped_train": lambda: bench_grouped_train.bench(10, 5, cfg=cfg),
        "profile_train_step": lambda: profile_train_step.bench(2, cfg=cfg),
    }


@pytest.mark.parametrize("name", ["get_default_net", "make_eval_step", "make_compute_loss", "Grounder",
                                  "make_train_step", "Learner", "main_dist", "bench_bottleneck",
                                  "bench_loss", "Grounder.from_checkpoint", "load_server_model",
                                  "serve.main", "predict.main", "export.main", "ExportedGrounder.load",
                                  "demo", "viz.main", "bench.main", "bench.run", "profile_bench",
                                  "bench_infer_ab", "bench_grouped_train", "profile_train_step"])
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
    """Every ROADMAP.md queue 1 item is ported, and the calls that once
    refused item 4 (spatial partitioning) now run: ``check_supported`` and
    ``check_servable`` pass ``mesh_spatial=2``, ``make_mesh`` builds the
    (data 1, spatial 2) mesh of a 2-rank group (two gloo processes) and
    ``load_server_model`` serves a checkpoint with two members.
    The serving formats of item 2 (canvas head, int8, exported artifacts)
    serve, item 2's host-data flags (``use_packed_cache``,
    ``use_tensorboard``, ``normalize_on_device=False``) run, and item 3's
    data parallel runs: ``--multi_host=True`` joins the process group that
    ``torch.distributed.run`` describes (here one gloo rank on the CPU),
    calls ``main_dist`` inside it on that rank's device and destroys the
    group at exit."""
    import socket
    import time

    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as tmp_mp

    import _torch_sp_worker as W

    from zsgnet_tpu_torch import main as t_main
    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.data.vocab import Vocab
    from zsgnet_tpu_torch.models.zsgnet import get_default_net
    from zsgnet_tpu_torch.parallel.mesh import make_mesh
    from zsgnet_tpu_torch.parallel.train_step import check_supported
    from zsgnet_tpu_torch.predict import check_servable
    from zsgnet_tpu_torch.serve import load_server_model
    from zsgnet_tpu_torch.train.checkpoint import CheckpointManager

    check_supported(Config(mesh_spatial=2))
    check_servable(Config(mesh_spatial=2))
    check_servable(Config(head_canvas=True, quant_mode="int8"))
    check_supported(Config(use_packed_cache=True, use_tensorboard=True, normalize_on_device=False))
    ctx = tmp_mp.start_processes(W.two_rank_mesh, args=(str(tmp_path / "store"), str(tmp_path)), nprocs=2,
                                 join=False, start_method="spawn")
    cfg = Config(resize_img=(64, 64), max_qlen=8, lstm_dim=8, emb_dim=8, fpn_ch=16, head_ch=16,
                 compute_dtype="float32")
    vocab = Vocab.build(["the red box"])
    ckpt = tmp_path / "ckpt"
    CheckpointManager(ckpt).save(0, {"model": get_default_net(cfg, len(vocab), device="cpu").state_dict()})
    (ckpt / "cfg.json").write_text(cfg.replace(vocab_size=len(vocab)).dumps())
    vocab.save(ckpt / "vocab.json")
    g = load_server_model(ckpt, batch_size=2, cfg_overrides={"mesh_spatial": "2"}, device="cpu")
    assert g.spatial == 2 and len(g.ground([np.zeros((64, 64, 3), np.uint8)], ["the red box"])) == 1
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the 2-rank make_mesh did not finish in 120 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    for r in (0, 1):
        got = torch.load(tmp_path / f"mesh_rank{r}.pt")
        assert got == {"spatial": 2, "data_size": 1, "data_index": 0, "spatial_index": r, "backend": "gloo"}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    seen = {}

    def main_dist(uid, device, **kw):
        seen.update(uid=uid, device=device, backend=dist.get_backend(), world=dist.get_world_size(), kw=kw)

    monkeypatch.setattr(t_main, "main_dist", main_dist)
    monkeypatch.setattr("sys.argv", ["main", "run1", "--multi_host=True", "--device=cpu", "--bs=4"])
    t_main.main()
    assert seen == dict(uid="run1", device=torch.device("cpu"), backend="gloo", world=1, kw={"bs": "4"})
    assert not dist.is_initialized()
