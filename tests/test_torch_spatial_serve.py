"""The port's spatial partitioning in one process on the CPU: ``halo_plan``
and ``spatial_train_mode`` against the JAX functions, the forward through the
in-process backend (``parallel.halo.LocalMesh``, one thread a member) against
one device and the JAX model, and spatial serving (``Grounder`` with
``mesh_spatial``, ``load_server_model``, the HTTP daemon) against the
single-device ``Grounder``. No process group.

* ``halo_plan`` equals the JAX function on every (h_local ≤ 40, k ∈ {1, 3,
  7}, stride ∈ {1, 2}, pad ≤ 3).
* The eval-mode forward with the height split over the members equals the
  port's single-device forward within 1e-5 (float32; measured ≤ 2.9e-6)
  and, for the batch that splits, the JAX ``ZSGNet`` within the budget of
  tests/test_torch_model.py, at 64²
  with S = 2 (every tap sharded, the FPN's upsample on local heights, P6
  reshards), 64×32 with S = 4 (layer4 reshards, the FPN meets mixed flags)
  and 80² with S = 2 (layer3 reshards; the upsample's non-integer ratio
  5 → 10 on resharded maps), for a batch that splits over the members and
  for one that does not (its members all-gather the height and agree).
* ``Grounder(mesh_spatial=2)`` on ``["cpu", "cpu"]`` and on four devices
  (two data groups) in buckets 1, 2 and 4: boxes within 1e-5 and scores
  within 1e-6 of the single-device ``Grounder``; the same in int8 against
  the single-device int8 ``Grounder`` (equal scales, calibrated unsharded); the same through
  ``load_server_model(cfg_overrides={"mesh_spatial": 2})`` on a checkpoint
  (one CPU device: the members share it) and through its HTTP daemon;
  JAX's refusal of an exported artifact with ``mesh_spatial``.
* JAX's training refusals: ``spatial_mode='gspmd'`` for retina and
  ``'halo'`` for SSD-VGG.
"""

import base64
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import QUERIES, cfg_pair, jax_variables, port_model, random_batch
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu.parallel.halo import halo_plan as j_halo_plan
from zsgnet_tpu.parallel.halo import spatial_train_mode as j_spatial_train_mode
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.models.quant import quant_scales
from zsgnet_tpu_torch.parallel.halo import LocalMesh, halo_plan, spatial_train_mode
from zsgnet_tpu_torch.parallel.train_step import check_supported
from zsgnet_tpu_torch.predict import Grounder, check_servable
from zsgnet_tpu_torch.serve import load_server_model, make_server
from zsgnet_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)
VOCAB = 30


def test_halo_plan_and_train_mode_equal_jax():
    for h in range(1, 41):
        for k in (1, 3, 7):
            for stride in (1, 2):
                for pad in range(4):
                    assert halo_plan(h, k, stride, pad) == j_halo_plan(h, k, stride, pad), (h, k, stride, pad)
    for mdl in ("retina", "ssd_vgg"):
        for mode in ("auto", "halo", "gspmd"):
            jcfg, tcfg = cfg_pair(mdl_to_use=mdl, spatial_mode=mode)
            assert spatial_train_mode(tcfg) == j_spatial_train_mode(jcfg)


def _spatial_forward(model, batch: dict, s: int) -> tuple[dict, dict]:
    """The model's forward with the image height split over ``s`` members
    on the CPU → (att_out, bbx_out) in batch order, and where it resharded."""
    img, qv, ql = (torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens"))
    mesh = LocalMesh([torch.device("cpu")] * s, s)
    try:
        (members,) = mesh.run(lambda d, ctx: (model(ctx.rows(img), qv, ql, spatial=ctx), ctx.landed))
    finally:
        mesh.close()
    outs = [o for o, _ in members]
    if img.shape[0] % s:  # gathered: every member carries the whole batch
        for o in outs[1:]:
            assert torch.equal(o["att_out"], outs[0]["att_out"])
        outs = outs[:1]
    got = {k: torch.cat([o[k] for o in outs]) for k in ("att_out", "bbx_out")}
    return got, members[0][1]


@pytest.mark.parametrize("size,s,landed", [
    ((64, 64), 2, {"fpn.p6", "fpn.out3", "fpn.out4", "fpn.out5"}),
    ((64, 32), 4, {"layer4.0", "fpn.lat4", "fpn.lat3"}),
    ((80, 80), 2, {"layer3.0", "fpn.lat3"}),
], ids=["64_s2", "64x32_s4", "80_s2"])
def test_local_spatial_forward_equals_one_device_and_jax(size, s, landed):
    jcfg, tcfg = cfg_pair(resize_img=size)
    variables = jax_variables(jcfg, VOCAB, seed=0)
    model = port_model(tcfg, variables, VOCAB)
    for b in (4, 3):
        batch = random_batch(np.random.default_rng(b), b, tcfg, VOCAB)
        with torch.inference_mode():
            one = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
        got, where = _spatial_forward(model, batch, s)
        assert set(where) == landed, where
        for k in ("att_out", "bbx_out"):
            np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
        if b == 4:
            want = jax.jit(lambda v, x: JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(v, x, train=False))(
                variables, {k: jnp.asarray(batch[k]) for k in ("img", "qvec", "qlens")})
            for k in ("att_out", "bbx_out"):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, rtol=2e-3, err_msg=k)


@pytest.fixture(scope="module")
def grounders(tmp_path_factory):
    jcfg, tcfg = cfg_pair()
    vocab = Vocab.build(QUERIES)
    sd = state_dict_from_jax(jax_variables(jcfg, len(vocab), seed=5), tcfg)
    one = Grounder(tcfg, vocab, sd, batch_size=4, device="cpu")
    d = tmp_path_factory.mktemp("sp_ckpt")
    CheckpointManager(d).save(0, {"model": one.model.state_dict(), "best_metric": -1.0})
    (d / "cfg.json").write_text(tcfg.replace(vocab_size=len(vocab)).dumps())
    vocab.save(d / "vocab.json")
    imgs = list(np.random.default_rng(3).integers(0, 256, size=(4, 64, 64, 3)).astype(np.uint8))
    return one, tcfg, vocab, sd, d, imgs


def _same(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["box_norm"], b["box_norm"], atol=1e-5, rtol=0)
        assert abs(a["score"] - b["score"]) <= 1e-6


def test_spatial_grounder_buckets_equal_one_device(grounders):
    one, cfg, vocab, sd, _, imgs = grounders
    queries = QUERIES[:4]
    for devices in (["cpu", "cpu"], ["cpu"] * 4):
        g = Grounder(cfg, vocab, sd, batch_size=4, devices=devices, mesh_spatial=2)
        assert g.bucket_sizes == ((1, 2, 4) if len(devices) == 2 else (2, 4))
        for n in (1, 2, 4):
            _same(g.ground(imgs[:n], queries[:n]), one.ground(imgs[:n], queries[:n]))
        _same(g.ground_image(imgs[0], queries[:3]), one.ground_image(imgs[0], queries[:3]))
        g.local_mesh.close()
    with pytest.raises(ValueError, match="must divide the image height 64"):
        check_servable(cfg, 3)


def test_spatial_int8_grounder_equals_one_device_int8(grounders):
    """int8 under ``mesh_spatial=2``: both Grounders calibrate on the same
    first batch through the unsharded model, so their scales are equal;
    the members' halo convs key them by the global input height."""
    _, cfg, vocab, sd, _, imgs = grounders
    kw = dict(batch_size=32, bucket_sizes=(1, 2, 4), quantize=True)
    one = Grounder(cfg, vocab, sd, device="cpu", **kw)
    g = Grounder(cfg, vocab, sd, devices=["cpu", "cpu"], mesh_spatial=2, **kw)
    try:
        first = g.ground(imgs, QUERIES[:4])
        _same(first, one.ground(imgs, QUERIES[:4]))
        scales = quant_scales(g.model)
        assert scales.keys() == quant_scales(one.model).keys()
        for k, v in quant_scales(one.model).items():
            assert torch.equal(scales[k], v), k
        for m, _ in g.replicas[1:]:  # no member made a scale of a local shape
            assert quant_scales(m).keys() == scales.keys()
        for n in (1, 2):
            _same(g.ground(imgs[:n], QUERIES[3:3 + n]), one.ground(imgs[:n], QUERIES[3:3 + n]))
    finally:
        g.local_mesh.close()


def test_load_server_model_serves_spatially_and_refuses_artifacts(grounders, tmp_path):
    one, _, _, _, d, imgs = grounders
    g = load_server_model(d, batch_size=4, cfg_overrides={"mesh_spatial": "2"}, device="cpu")
    assert g.spatial == 2 and g.devices == [torch.device("cpu")] * 2
    _same(g.ground(imgs[:1], QUERIES[:1]), one.ground(imgs[:1], QUERIES[:1]))
    srv = make_server(g, port=0, window_ms=5.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        buf = io.BytesIO()
        Image.fromarray(imgs[2]).save(buf, format="PNG")
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/ground",
            data=json.dumps({"query": QUERIES[2], "image_b64": base64.b64encode(buf.getvalue()).decode()}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            res = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    _same([res], one.ground(imgs[2:3], QUERIES[2:3]))
    (tmp_path / "export.json").write_text(json.dumps({"version": 3, "format": "torch.export"}))
    with pytest.raises(ValueError, match="mesh_spatial serving needs a checkpoint dir"):
        load_server_model(tmp_path, cfg_overrides={"mesh_spatial": 2}, device="cpu")


def test_spatial_training_refusals_keep_the_jax_words():
    with pytest.raises(NotImplementedError, match="spatial_mode='gspmd' training is not supported for "
                                                  "mdl_to_use='retina'"):
        check_supported(Config(mesh_spatial=2, spatial_mode="gspmd"))
    with pytest.raises(NotImplementedError, match="spatial_mode='halo' is implemented for retina only"):
        check_supported(Config(mesh_spatial=2, spatial_mode="halo", mdl_to_use="ssd_vgg"))
    check_supported(Config(mesh_spatial=2, mdl_to_use="ssd_vgg"))  # auto: the VGG tower split by height
    check_supported(Config(mesh_spatial=2))
