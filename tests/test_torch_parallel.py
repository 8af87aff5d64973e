"""The port's data-parallel pieces in one process on the CPU.

* The sharded loaders: over 2 and 4 shards the slices of every global
  batch, concatenated in shard order, are the unsharded batch, and each
  slice is the JAX ``BatchLoader(shard_id, num_shards)`` slice, exactly
  (flat, grouped with ``pair_valid``, through the packed cache, and the
  wrap-padded evaluation tail with its ``valid``). An indivisible global
  batch raises the JAX error.
* With one rank in a gloo process group: the synchronized BatchNorm's
  autograd function against ``F.batch_norm`` (outputs atol 1e-5, gradients
  atol 1e-4, on values of order 1: float32 in another summation order;
  the biased variance rtol 1e-5), the model's BatchNorm taking the plain
  path there with no collective, and the losses given ``group=`` against
  the plain ones (rtol 1e-6, gradients atol 1e-7).
* With no process group no collective runs: a Learner (``do_dist=True``)
  takes an epoch of train steps and validates with every collective
  patched to raise.
* ``make_mesh`` refuses a 2-D mesh shape and a ``mesh_spatial`` that does
  not divide the ranks, as the JAX one does.
* Data-parallel serving: ``Grounder(devices=["cpu", "cpu"])`` (two
  replicas, each device batch split between them) and an
  ``ExportedGrounder`` round-robin over two devices answer as the
  single-device ones (boxes and scores within 1e-5), and the Grounder's
  divisibility errors are the JAX Grounder's on a 2-device mesh.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from _torch_port import cfg_pair
from zsgnet_tpu.data.dataset import get_data as j_get_data
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data import synthetic
from zsgnet_tpu_torch.data.dataset import BatchLoader, get_data
from zsgnet_tpu_torch.models import resnet
from zsgnet_tpu_torch.ops import losses
from zsgnet_tpu_torch.ops.cuda import fused_loss as fl
from zsgnet_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {}
    for kind, kw in (("flat", dict(n_train=18, n_val=11, seed=5)),
                     ("grouped", dict(n_train=12, n_val=7, seed=6, all_objects=True))):
        root = tmp_path_factory.mktemp(kind)
        synthetic.generate(root, n_test=4, img_size=32, **kw)
        out[kind] = root
    return out


LOADERS = {
    "flat": dict(bs=8),
    "packed": dict(bs=8, use_packed_cache=True),
    "grouped": dict(bs=4, queries_per_img=2),
}


def _batches(dl, epoch: int) -> list[dict]:
    dl.set_epoch(epoch)
    return list(dl)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind", list(LOADERS))
def test_sharded_loaders_slice_the_global_batch_as_jax(roots, kind, shards):
    kw = dict(ds_to_use="synthetic", data_dir=str(roots["grouped" if kind == "grouped" else "flat"]),
              resize_img=(32, 32), max_qlen=6, nw=1, seed=7, **LOADERS[kind])
    jcfg, tcfg = cfg_pair(**kw)
    whole = get_data(tcfg)
    parts = [get_data(tcfg, shard_id=r, num_shards=shards) for r in range(shards)]
    jparts = [j_get_data(jcfg, shard_id=r, num_shards=shards) for r in range(shards)]
    for split in ("train_dl", "valid_dl"):
        for epoch in (0, 1):
            want = _batches(getattr(whole, split), epoch)
            got = [_batches(getattr(p, split), epoch) for p in parts]
            jgot = [_batches(getattr(p, split), epoch) for p in jparts]
            assert all(len(g) == len(want) for g in got + jgot)
            for i, wb in enumerate(want):
                for r in range(shards):
                    assert set(got[r][i]) == set(jgot[r][i]) == set(wb)
                    for k in wb:
                        np.testing.assert_array_equal(got[r][i][k], jgot[r][i][k], err_msg=f"{split} {k}")
                for k in wb:
                    np.testing.assert_array_equal(np.concatenate([g[i][k] for g in got]), wb[k],
                                                  err_msg=f"{split} {k}")
    if kind != "grouped":  # 11 rows: a tail of 3 in the global batch of 8
        assert not _batches(whole.valid_dl, 0)[-1]["valid"].all()
    else:
        assert not np.concatenate([b["pair_valid"] for b in _batches(whole.train_dl, 0)]).all()


def test_indivisible_global_batch_raises_the_jax_error():
    from zsgnet_tpu.data.dataset import BatchLoader as JBatchLoader

    for loader in (BatchLoader, JBatchLoader):
        with pytest.raises(ValueError, match="global batch size 6 not divisible by 4 hosts"):
            loader(list(range(12)), 6, shuffle=False, shard_id=1, num_shards=4).first_batch()


# ------------------------------------------------------- one gloo rank


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _refuse(*a, **k):
    raise AssertionError("a collective ran")


def test_sync_batch_norm_function_equals_batch_norm(world1, monkeypatch):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(1.0, 2.0, size=(4, 6, 5, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=6).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=6).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    res = {}
    for name in ("sync", "plain"):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        if name == "sync":
            y, mean, var = resnet._SyncBatchNorm.apply(xs, ws, bs, 1e-5, world1)
        else:
            y = F.batch_norm(xs, None, None, ws, bs, True, 0.1, 1e-5)
        y.backward(dy)
        res[name] = (y.detach(), xs.grad, ws.grad, bs.grad)
    for got, want, atol in zip(res["sync"], res["plain"], (1e-5, 1e-4, 1e-4, 1e-4)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol, rtol=0)
    np.testing.assert_allclose(mean.numpy(), x.mean((0, 2, 3)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), x.var((0, 2, 3), unbiased=False).numpy(), rtol=1e-5)

    # The module at one rank: the plain path, no collective, the same output
    # and running statistics as an unsynchronized BatchNorm.
    monkeypatch.setattr(dist, "all_reduce", _refuse)
    bns = {s: resnet.BatchNorm2d(6, sync=s).train() for s in (True, False)}
    ys = {s: bn(x) for s, bn in bns.items()}
    assert torch.equal(ys[True], ys[False])
    for k in ("running_mean", "running_var"):
        assert torch.equal(getattr(bns[True], k), getattr(bns[False], k))
    np.testing.assert_allclose(bns[True].running_var.numpy(),
                               (0.9 + 0.1 * x.var((0, 2, 3), unbiased=False)).numpy(), rtol=1e-5)


@pytest.mark.parametrize("variant", ["fused", "bce", "softmax"])
def test_losses_with_a_group_equal_the_plain_losses(world1, variant):
    from zsgnet_tpu_torch.ops import anchors as anchor_ops

    rng = np.random.default_rng(1)
    sizes = anchor_ops.feature_map_sizes((64, 64), strides=(8, 16, 32))
    anchors = anchor_ops.create_anchors((1.0, 1.26), (0.5, 1.0, 2.0), sizes)
    att = torch.from_numpy(rng.normal(size=(4, anchors.shape[0])).astype(np.float32))
    bbx = torch.from_numpy(rng.normal(size=(4, anchors.shape[0], 4)).astype(np.float32))
    lo = rng.uniform(-1, 0.4, size=(4, 2))
    gt = torch.from_numpy(np.concatenate([lo, lo + 0.5], 1).astype(np.float32))
    w = torch.tensor([1.0, 0.0, 1.0, 1.0])
    out = {}
    for group in (None, world1):
        a, bb = att.clone().requires_grad_(), bbx.clone().requires_grad_()
        if variant == "fused":
            ls = fl.zsg_loss_fused(a, bb, fl.pack_anchors(anchors, "cpu"), gt, sample_weight=w, group=group)
        else:
            labels, reg_t = anchor_ops.match_and_encode(torch.from_numpy(anchors), gt)
            ls = losses.zsg_loss(a, bb, labels, reg_t, use_focal=False, use_softmax=variant == "softmax",
                                 sample_weight=w, group=group)
        ls["total"].backward()
        out[group is None] = ({k: float(v.detach()) for k, v in ls.items()}, a.grad, bb.grad)
    (got, ga, gb), (want, wa, wb) = out[False], out[True]
    assert got["num_pos"] == want["num_pos"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(ga.numpy(), wa.numpy(), atol=1e-7, rtol=0)
    np.testing.assert_allclose(gb.numpy(), wb.numpy(), atol=1e-7, rtol=0)


def test_make_mesh_keeps_the_jax_checks(world1):
    with pytest.raises(ValueError, match="1-D data mesh"):
        make_mesh(Config(mesh_shape=(2, 2)), "cpu")
    with pytest.raises(ValueError, match="mesh_spatial=2 does not divide the 1 devices"):
        make_mesh(Config(mesh_spatial=2), "cpu")
    with pytest.raises(ValueError, match="spans every rank"):
        make_mesh(Config(mesh_shape=(2,)), "cpu")
    mesh = make_mesh(Config(), "cpu")
    assert (mesh.rank, mesh.world_size, mesh.backend) == (0, 1, "gloo")


def test_no_process_group_issues_no_collective(roots, tmp_path, monkeypatch):
    """A do_dist Learner with no process group trains an epoch and validates
    through the single-device steps: every collective raises if called."""
    from zsgnet_tpu_torch.train.learner import Learner

    for name in ("all_reduce", "all_gather", "all_gather_object", "broadcast", "barrier", "reduce_scatter"):
        monkeypatch.setattr(dist, name, _refuse)
    assert not dist.is_initialized()
    cfg = Config(ds_to_use="synthetic", data_dir=str(roots["flat"]), bs=6, nw=1, resize_img=(32, 32),
                 max_qlen=6, lstm_dim=8, emb_dim=8, fpn_ch=16, head_ch=16, compute_dtype="float32",
                 do_dist=True, epochs=1, tmp_path=str(tmp_path), log_every=1)
    learn = Learner("solo", get_data(cfg), cfg, device="cpu")
    assert learn.mesh is None
    for batch in learn.data.train_dl:
        learn.state, ls = learn.train_step(learn.state, batch)
    assert learn.state.step == 3 and np.isfinite(float(ls["total"]))
    assert np.isfinite(learn.validate()["loss"])


# -------------------------------------------------------------- serving


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from _torch_port import jax_variables
    from zsgnet_tpu_torch.convert import state_dict_from_jax
    from zsgnet_tpu_torch.data.vocab import Vocab

    queries = ["the red box", "a blue ellipse on the left", "the left thing", "red box"]
    jcfg, tcfg = cfg_pair()
    vocab = Vocab.build(queries)
    sd = state_dict_from_jax(jax_variables(jcfg, len(vocab), seed=4), tcfg)
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8) for _ in range(7)]
    return tcfg, vocab, sd, images, (queries * 2)[:7], tmp_path_factory.mktemp("art")


def _same(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["box_norm"], b["box_norm"], atol=1e-5)
        assert abs(a["score"] - b["score"]) < 1e-5


def test_data_parallel_grounder_answers_as_one_device(served):
    from zsgnet_tpu_torch.predict import Grounder

    cfg, vocab, sd, images, queries, _ = served
    one = Grounder(cfg, vocab, sd, batch_size=4, device="cpu")
    two = Grounder(cfg, vocab, sd, batch_size=4, devices=["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.bucket_sizes == (2, 4)
    _same(two.ground(images, queries), one.ground(images, queries))
    _same(two.ground_image(images[0], queries[:3]), one.ground_image(images[0], queries[:3]))
    two.warmup(multiquery=True)


def test_data_parallel_divisibility_errors_are_jax_errors(served):
    import jax

    from zsgnet_tpu.config import Config as JConfig
    from zsgnet_tpu.data.vocab import Vocab as JVocab
    from zsgnet_tpu.parallel.mesh import make_mesh as j_make_mesh
    from zsgnet_tpu.predict import Grounder as JGrounder
    from zsgnet_tpu_torch.predict import Grounder

    cfg, vocab, sd, *_ = served
    jcfg, _ = cfg_pair()
    jmesh = j_make_mesh(JConfig(mesh_shape=(2,)), jax.devices()[:2])
    jvocab = JVocab(vocab.word_to_id)
    for kw in (dict(batch_size=3), dict(batch_size=4, bucket_sizes=(1, 4))):
        with pytest.raises(ValueError) as want:
            JGrounder(jcfg, jvocab, {}, mesh=jmesh, **kw)
        with pytest.raises(ValueError) as got:
            Grounder(cfg, vocab, sd, devices=["cpu", "cpu"], **kw)
        assert str(got.value) == str(want.value)


def test_round_robin_exported_grounder_answers_as_one_device(served):
    from zsgnet_tpu_torch.export import ExportedGrounder, export_serving
    from zsgnet_tpu_torch.predict import Grounder

    cfg, vocab, sd, images, queries, tmp = served
    g = Grounder(cfg, vocab, sd, batch_size=2, bucket_sizes=(2,), device="cpu")
    export_serving(g, tmp / "a", platforms=["cpu"])
    one = ExportedGrounder.load(tmp / "a", device="cpu")
    rr = ExportedGrounder.load(tmp / "a", devices=["cpu", "cpu"])
    assert rr._devices == [torch.device("cpu")] * 2
    assert ExportedGrounder.load(tmp / "a", device="cpu", data_parallel=True)._devices is None
    _same(rr.ground(images, queries), one.ground(images, queries))
    assert rr.dispatch_counts == {torch.device("cpu"): 4}
    _same(rr.ground(images, queries), g.ground(images, queries))
