"""The port's Learner, loader, checkpoints and ``main_dist`` on the CPU, on
the port's synthetic data at a tiny size; each case mirrors one of
tests/test_train.py. Where a host-side piece has a JAX twin (the loader's
batch order, the plateau scheduler, the smoothed loss) the two are held
against each other exactly. Exactness claims inside the port (resume,
checkpoint round trip) are bit-equal: one CPU thread, the same seed and
batch order."""

import json
import shutil

import numpy as np
import pytest
import torch

from zsgnet_tpu.config import Config as JConfig
from zsgnet_tpu.data.dataset import get_data as j_get_data
from zsgnet_tpu.train import learner as j_learner
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data import synthetic
from zsgnet_tpu_torch.data.dataset import get_data
from zsgnet_tpu_torch.main import main_dist
from zsgnet_tpu_torch.train.learner import Learner, PlateauScheduler, SmoothenValue

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    synthetic.generate(root, n_train=16, n_val=8, n_test=8, img_size=64)
    return root


TINY = dict(
    ds_to_use="synthetic", bs=8, nw=2, lr=2e-3, resize_img=(64, 64), max_qlen=8,
    lstm_dim=16, emb_dim=16, fpn_ch=32, head_ch=32, compute_dtype="float32",
    log_every=1, seed=3,
)


def tiny_cfg(root, tmp, **kw):
    return Config(**{**TINY, "data_dir": str(root), "tmp_path": str(tmp), **kw})


def _params(learn):
    return {k: v.detach().clone() for k, v in learn.model.state_dict().items()}


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_smoothen_value_matches_jax():
    t, j = SmoothenValue(beta=0.5), j_learner.SmoothenValue(beta=0.5)
    for v in (1.0, 0.0, 3.5, 2.0):
        t.add_value(v)
        j.add_value(v)
        assert t.smooth == j.smooth


def test_plateau_scheduler_matches_jax():
    t, j = PlateauScheduler(factor=0.5, patience=2), j_learner.PlateauScheduler(factor=0.5, patience=2)
    for metric in (0.5, 0.5, 0.5, 0.5, 0.6, 0.6, 0.6, 0.6, 0.60005, 0.7):
        assert t.step(metric) == j.step(metric)
        assert (t.best, t.num_bad) == (j.best, j.num_bad)
    assert t.scale == 0.25


def test_batch_loader_order_matches_jax(synth_root, tmp_path):
    """Shuffled drop-last train batches over 2 epochs, the wrap-padded
    validation batches, and a one-shot start_batch, against the JAX loader."""
    kw = dict(TINY, bs=3, nw=1, data_dir=str(synth_root), tmp_path=str(tmp_path))
    t_data = get_data(Config(**kw))
    j_data = j_get_data(JConfig(**{**kw, "use_pallas": False}))
    assert t_data.vocab.word_to_id == j_data.vocab.word_to_id
    for epoch in (0, 1):
        t_data.train_dl.set_epoch(epoch)
        j_data.train_dl.set_epoch(epoch)
        t_idx = [b["idxs"].tolist() for b in t_data.train_dl]
        assert t_idx == [b["idxs"].tolist() for b in j_data.train_dl]
        assert len(t_idx) == 5 and len({i for b in t_idx for i in b}) == 15
    assert t_idx != [list(range(i, i + 3)) for i in range(0, 15, 3)]  # shuffled
    for t_dl, j_dl in ((t_data.valid_dl, j_data.valid_dl), (t_data.test_dl, j_data.test_dl)):
        tb, jb = list(t_dl), list(j_dl)
        assert [b["idxs"].tolist() for b in tb] == [b["idxs"].tolist() for b in jb]
        assert [b["valid"].tolist() for b in tb] == [b["valid"].tolist() for b in jb]
    dl = t_data.train_dl
    dl.set_epoch(5)
    full = [b["idxs"].tolist() for b in dl]
    dl.start_batch = 2
    assert [b["idxs"].tolist() for b in dl] == full[2:]
    assert dl.start_batch == 0 and len(list(dl)) == len(full)
    np.testing.assert_array_equal(dl.first_batch()["idxs"], full[0])


def test_overfit_batch_loss_decreases(synth_root, tmp_path):
    cfg = tiny_cfg(synth_root, tmp_path)
    learn = Learner("t_overfit", get_data(cfg), cfg, device="cpu")
    first, last = learn.overfit_batch(steps=12)
    assert last < first * 0.5, (first, last)
    assert learn.state.step == 12


def test_fit_one_epoch_and_checkpoint_roundtrip(synth_root, tmp_path):
    cfg = tiny_cfg(synth_root, tmp_path, epochs=1)
    data = get_data(cfg)
    learn = Learner("t_fit", data, cfg, device="cpu")
    learn.fit(1)
    rows = [json.loads(x) for x in learn.log_file.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["step"] == 2 and np.isfinite(rows[0]["train_total"])
    m1 = learn.validate()
    assert {"Acc", "MaxPos", "MeanIoU", "loss"} <= set(m1) and m1["num_samples"] == 8
    assert learn.ckpt.latest_step() == 2 and learn.ckpt_best.latest_step() == 2
    assert (learn.model_dir / "cfg.json").exists() and (learn.model_dir / "vocab.json").exists()
    # restore() reads with torch.load(weights_only=True).
    assert {"model", "optimizer", "step", "epoch", "lr_scale"} <= set(learn.ckpt.top_level_keys())

    learn2 = Learner("t_fit", data, cfg.replace(resume=True), device="cpu")
    assert (learn2.state.step, learn2.epoch) == (2, 1)
    _assert_same(_params(learn2), _params(learn))
    m2 = learn2.validate()
    assert m2 == m1
    learn2.fit(1)  # the budget is spent: nothing to train
    assert learn2.state.step == 2


def test_midepoch_resume_exact(synth_root, tmp_path):
    """ckpt_every_steps: restore the batch-2 save of a 4-batch epoch and
    finish it; parameters, BatchNorm statistics and optimizer state equal
    the uninterrupted run's."""
    kw = dict(bs=4, nw=1, opt_to_use="sgd", ckpt_every_steps=2, epochs=1)
    cfg_a = tiny_cfg(synth_root, tmp_path / "a", **kw)
    learn_a = Learner("t_mid", get_data(cfg_a), cfg_a, device="cpu")
    learn_a.fit(1)
    assert learn_a.state.step == 4

    cfg_b = tiny_cfg(synth_root, tmp_path / "b", **kw)
    data_b = get_data(cfg_b)
    Learner("t_mid", data_b, cfg_b, device="cpu").fit(1)  # saves step 2 on the way
    learn_c = Learner("t_mid", data_b, cfg_b, device="cpu")
    learn_c.load_model_dict(step=2)
    assert (learn_c.epoch, learn_c._resume_batches, learn_c.state.step) == (0, 2, 2)
    learn_c.fit(1)
    assert (learn_c.state.step, learn_c.epoch) == (4, 1)
    _assert_same(_params(learn_c), _params(learn_a))
    sa, sc = learn_a.state.optimizer.state_dict()["state"], learn_c.state.optimizer.state_dict()["state"]
    assert set(sa) == set(sc)
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sc[k]["momentum_buffer"])


def test_request_stop_resumes_exact(synth_root, tmp_path):
    """request_stop (SIGTERM in main_dist) after 3 steps saves the position;
    a resumed Learner finishes with the uninterrupted run's parameters."""
    kw = dict(bs=4, nw=1, opt_to_use="sgd", epochs=1)
    cfg_a = tiny_cfg(synth_root, tmp_path / "a", **kw)
    learn_a = Learner("t_stop", get_data(cfg_a), cfg_a, device="cpu")
    learn_a.fit(1)

    cfg_b = tiny_cfg(synth_root, tmp_path / "b", **kw)
    data_b = get_data(cfg_b)
    learn_b = Learner("t_stop", data_b, cfg_b, device="cpu")
    step = learn_b.train_step

    def stepping(state, batch):
        out = step(state, batch)
        if state.step == 3:
            learn_b.request_stop()
        return out

    learn_b._train_step = stepping
    learn_b.fit(1)
    assert (learn_b.state.step, learn_b.epoch) == (3, 0)
    resumed = Learner("t_stop", data_b, cfg_b.replace(resume=True), device="cpu")
    assert resumed._resume_batches == 3
    resumed.fit(1)
    assert (resumed.state.step, resumed.epoch) == (4, 1)
    _assert_same(_params(resumed), _params(learn_a))


def test_best_checkpoint_survives_rotation(synth_root, tmp_path):
    cfg = tiny_cfg(synth_root, tmp_path)
    data = get_data(cfg)
    learn = Learner("t_best", data, cfg, device="cpu")
    learn.overfit_batch(steps=1)
    learn.best_metric = 0.9
    learn.save_model_dict(best=True)
    best = _params(learn)
    for _ in range(4):  # steps 2..5, none of them best
        learn.overfit_batch(steps=1)
        learn.save_model_dict(best=False)
    assert learn.ckpt.all_steps() == [3, 4, 5]
    assert learn.ckpt_best.all_steps() == [1]

    learn2 = Learner("t_best", data, cfg, device="cpu")
    learn2.load_model_dict(prefer_best=True)
    assert learn2.state.step == 1 and learn2.best_metric == 0.9
    _assert_same(_params(learn2), best)


def test_partial_warm_start_load(synth_root, tmp_path):
    """load_normally=False loads the tensors whose name and shape match and
    keeps the optimizer fresh; a wider head stays at its fresh init."""
    cfg = tiny_cfg(synth_root, tmp_path)
    data = get_data(cfg)
    learn = Learner("t_warm", data, cfg, device="cpu")
    learn.overfit_batch(steps=2)
    learn.save_model_dict()
    trained = _params(learn)

    cfg2 = cfg.replace(resume=True, load_normally=False, seed=99, head_ch=48)
    learn2 = Learner("t_warm", data, cfg2, device="cpu")
    got = _params(learn2)
    assert torch.equal(got["backbone.encoder.conv1.weight"], trained["backbone.encoder.conv1.weight"])
    fresh = Learner("t_fresh", data, cfg2.replace(resume=False), device="cpu")
    assert torch.equal(got["head.conv1.weight"], _params(fresh)["head.conv1.weight"])
    assert learn2.state.optimizer.state_dict()["state"] == {}


def test_fit_lr_override_preserves_adam_moments(synth_root, tmp_path):
    cfg = tiny_cfg(synth_root, tmp_path, epochs=3, nw=1)
    data = get_data(cfg)
    learn = Learner("t_lr", data, cfg, device="cpu")
    learn.fit(1)

    def moments():
        return [s["exp_avg"].clone() for s in learn.state.optimizer.state.values()]

    before = moments()
    learn.fit(2, lr=cfg.lr / 10)
    assert abs(learn.state.lr_scale - 0.1) < 1e-12
    assert learn._effective_lr() == pytest.approx(cfg.lr / 10, rel=1e-12)
    assert all(g["lr"] == pytest.approx(cfg.lr / 10) for g in learn.state.optimizer.param_groups)
    # Two more Adam steps from the trained moments: m = 0.9²·m_before + ...;
    # a reset would leave only 0.19 of the new gradients.
    after = moments()
    assert sum(float(a.abs().sum()) for a in after) > 0.25 * sum(float(b.abs().sum()) for b in before)
    learn.save_model_dict()
    learn2 = Learner("t_lr", data, cfg, device="cpu")
    learn2.load_model_dict()
    assert abs(learn2.state.lr_scale - 0.1) < 1e-12
    for a, b in zip(after, [s["exp_avg"] for s in learn2.state.optimizer.state.values()]):
        assert torch.equal(a, b)


def test_fit_warns_past_decay_horizon(synth_root, tmp_path, capsys):
    cfg = tiny_cfg(synth_root, tmp_path, epochs=1, lr_schedule="cosine")
    data = get_data(cfg)
    learn = Learner("t_horizon", data, cfg, device="cpu")
    assert learn.cfg.lr_decay_steps == len(data.train_dl)
    learn.epoch = 3
    learn.fit(3)
    out = capsys.readouterr().out
    assert "exceed the LR decay horizon" in out and "nothing to train" in out
    assert learn.state.step == 0


def _tb_scalars(tb_dir) -> dict[tuple[str, int], float]:
    """(tag, step) → value of every scalar in the TensorBoard event files."""
    import struct

    from tensorboardX.proto import event_pb2

    out = {}
    for path in sorted(tb_dir.glob("events.out.tfevents.*")):
        data, off = path.read_bytes(), 0
        while off < len(data):
            (n,) = struct.unpack("<Q", data[off : off + 8])
            event = event_pb2.Event.FromString(data[off + 12 : off + 12 + n])
            off += 16 + n
            for v in event.summary.value:
                out[(v.tag, event.step)] = v.simple_value
    return out


def test_tensorboard_rows_hold_every_numeric_key(synth_root, tmp_path):
    """With ``use_tensorboard`` every numeric key of each JSONL row but
    ``step`` is a scalar at the row's step (its epoch when it has none), as
    the JAX Learner writes them."""
    pytest.importorskip("tensorboardX")
    cfg = tiny_cfg(synth_root, tmp_path, epochs=1, use_tensorboard=True)
    learn = Learner("t_tb", get_data(cfg), cfg, device="cpu")
    learn.fit(1)
    learn._log_row({"epoch": 3, "note": "text", "val_Acc": 0.5, "flag": True})
    rows = [json.loads(x) for x in learn.log_file.read_text().splitlines()]
    scalars = _tb_scalars(tmp_path / "logs" / "tb" / "t_tb")
    want = {(k, int(r.get("step", r.get("epoch", 0)))): float(v) for r in rows for k, v in r.items()
            if isinstance(v, (int, float)) and k != "step"}
    assert len(rows) == 2 and ("train_total", 2) in want and ("val_Acc", 3) in want
    assert set(scalars) == set(want)
    for key, v in want.items():
        assert scalars[key] == pytest.approx(v, rel=1e-6), key


def test_validation_uses_ema_weights_with_live_bn_stats(synth_root, tmp_path):
    cfg = tiny_cfg(synth_root, tmp_path, ema_decay=0.9)
    data = get_data(cfg)
    learn = Learner("t_ema", data, cfg, device="cpu")
    learn.overfit_batch(steps=3)
    raw = _params(learn)
    got = learn.validate()
    _assert_same(_params(learn), raw)  # the raw parameters are back
    with torch.no_grad():
        for n, p in learn.model.named_parameters():
            p.copy_(learn.state.ema[n])
    want = learn._run_eval(data.valid_dl)
    assert got == want
    assert not torch.equal(learn.state.ema["head.out.bias"], raw["head.out.bias"])


@pytest.mark.parametrize("key,value", [("mesh_spatial", 2)])
def test_unported_options_raise(synth_root, tmp_path, key, value):
    cfg = tiny_cfg(synth_root, tmp_path, **{key: value})
    with pytest.raises(RuntimeError, match="one process per member"):
        Learner("t_unported", None, cfg, device="cpu")


def test_command_line_matches_jax(monkeypatch, synth_root, tmp_path):
    """The same argv parses to the same uid, overrides and multi_host flag
    as the JAX ``main.py``; ``--list_flags`` names the same flags;
    ``--multi_host=True`` without the ``torch.distributed.run`` environment
    raises (no single-process fallback), and with it (one gloo rank on the
    CPU) trains, validates and checkpoints under the data mesh, then
    destroys the process group."""
    import socket

    import torch.distributed as dist

    from zsgnet_tpu import main as j_main
    from zsgnet_tpu_torch import main as t_main

    argv = ["run1", "--bs=8", "--lr=2e-4", "--multi_host=False", "--device=cpu", "--ds_to_use=synthetic"]
    uid, overrides, multi_host, device = t_main.parse_args(argv)
    j_argv = [a for a in argv if not a.startswith("--device")]
    assert (uid, overrides, multi_host) == j_main.parse_args(j_argv) and device == "cpu"
    assert t_main.parse_args(["run1"])[3] == "cuda"
    with pytest.raises(SystemExit) as t_flags:
        t_main.parse_args(["--list_flags"])
    with pytest.raises(SystemExit) as j_flags:
        j_main.parse_args(["--list_flags"])
    flag_names = lambda text: {ln.split("=")[0].strip() for ln in text.splitlines()[1:]}  # noqa: E731
    assert flag_names(str(t_flags.value)) == flag_names(str(j_flags.value))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr("sys.argv", ["main", "run1", "--multi_host=True", "--device=cpu"])
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        t_main.main()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    argv = [f"--{k}={list(v) if isinstance(v, tuple) else v}" for k, v in TINY.items()]
    monkeypatch.setattr("sys.argv", ["main", "mh", "--multi_host=True", "--device=cpu", "--epochs=1",
                                     f"--data_dir={synth_root}", f"--tmp_path={tmp_path}", *argv])
    t_main.main()
    assert not dist.is_initialized()
    rows = [json.loads(x) for x in (tmp_path / "logs" / "mh.jsonl").read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["step"] == 2 and np.isfinite(rows[0]["val_loss"])
    assert (tmp_path / "models" / "mh" / "step_2.pt").exists()
    shutil.rmtree(tmp_path / "models")  # ~0.6 GB of checkpoints


def test_main_dist_end_to_end(synth_root, tmp_path):
    kw = {k: v for k, v in TINY.items()}
    kw.update(data_dir=str(synth_root), tmp_path=str(tmp_path), epochs=1, do_dist=True)
    metrics = main_dist("t_main", device="cpu", **kw)
    assert {"Acc", "MaxPos", "loss"} <= set(metrics) and np.isfinite(metrics["loss"])
    assert (tmp_path / "logs" / "t_main.jsonl").exists()
    # --resume with only the uid and the paths: cfg.json is the config base.
    again = main_dist("t_main", device="cpu", resume=True, only_val=True,
                      data_dir=str(synth_root), tmp_path=str(tmp_path))
    assert again == metrics
