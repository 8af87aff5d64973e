"""SSD-VGG16 split by height in one process on the CPU (the port's
counterpart of the JAX ``gspmd`` spatial mode): ``halo_plan`` with a
dilation against a brute-force dilated convolution over halo-padded shards,
the forward through the in-process backend (``parallel.halo.LocalMesh``, one
thread a member) against one device and the JAX model, and the spatial
``Grounder`` against the single-device one. No process group.

* ``halo_plan(h, k, stride, pad, dilation)``: wherever it admits the op, the
  VALID convolution of every shard padded with its halo rows (zeros at the
  ring ends) gives that shard's rows of the one-device convolution over
  the whole height, exactly (float64), h/stride rows a shard. h ≤ 16 on 3
  shards, k ∈ {1, 3}, stride ∈ {1, 2}, pad ≤ 6, dilation ∈ {1, 2, 6}.
* The eval-mode forward with the image height split over the members
  equals the single-device forward within 1e-5 (float32) and, for the batch
  that splits, the JAX ``ZSGNet`` within tests/test_torch_model.py's budget
  (atol 5e-4, rtol 2e-3), for a batch that splits over the members and one
  that does not (the members gather it and agree). Where the reshard or
  gather lands, by size: 64² at S = 2 and 64×32 at S = 4 at conv6
  (``vgg.31``, its 6-row dilated halo exceeds the shard) with the conv4_3 tap
  resharded on its own; 80² at S = 2 at pool4 (``vgg.23``, odd local height)
  and the tap; 300² at S = 2 at pool2 (``vgg.9``).
* ``Grounder(mesh_spatial=2)`` with SSD-VGG16 on ``["cpu", "cpu"]`` in
  buckets 1, 2 and 4: boxes within 1e-5 and scores within 1e-6 of the
  single-device ``Grounder``, in float32 and in int8 (scales calibrated on
  the unsharded model, equal on both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import QUERIES, cfg_pair, jax_variables, port_model, random_batch
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.models.quant import quant_scales
from zsgnet_tpu_torch.parallel.halo import LocalMesh, halo_plan
from zsgnet_tpu_torch.predict import Grounder

torch.set_num_threads(1)
VOCAB = 30


def _sharded_conv_rows(x: torch.Tensor, w: torch.Tensor, s: int, stride: int, pad: int, d: int,
                       plan: tuple[int, int]) -> torch.Tensor:
    """Each of ``s`` shards of ``x``'s rows padded with its halo (the
    neighbours' rows, zeros at the ring ends), convolved VALID in height;
    the outputs concatenated."""
    h = x.shape[2] // s
    ht, hb = plan
    padded = F.pad(x, (0, 0, ht, hb))
    outs = [F.conv2d(padded[:, :, i * h:i * h + h + ht + hb], w, stride=stride, padding=(0, pad), dilation=d)
            for i in range(s)]
    return torch.cat(outs, dim=2)


def test_halo_plan_with_dilation_equals_a_dilated_conv_over_halo_padded_shards():
    rng = np.random.default_rng(0)
    s, admitted = 3, 0
    for h in range(1, 17):
        for k in (1, 3):
            for stride in (1, 2):
                for pad in range(7):
                    for d in (1, 2, 6):
                        plan = halo_plan(h, k, stride, pad, d)
                        if plan is None:
                            continue
                        admitted += 1
                        x = torch.from_numpy(rng.normal(size=(1, 2, s * h, 13)))
                        w = torch.from_numpy(rng.normal(size=(2, 2, k, k)))
                        # One device: the conv over the whole height, padded as the ring ends are.
                        want = F.conv2d(F.pad(x, (0, 0, *plan)), w, stride=stride, padding=(0, pad), dilation=d)
                        assert plan[0] == pad and want.shape[2] == s * (h // stride), (h, k, stride, pad, d)
                        got = _sharded_conv_rows(x, w, s, stride, pad, d, plan)
                        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    # conv6 (3×3, dilation 6, pad 6): a 6-row halo each side, so a shard needs 6 rows.
    assert halo_plan(2, 3, 1, 6, 6) is None and halo_plan(6, 3, 1, 6, 6) == (6, 6)
    assert halo_plan(5, 3, 1, 6, 6) is None and halo_plan(2, 3, 1, 1) == (1, 1)
    assert admitted > 100


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
    ((64, 64), 2, {"conv4_3": (512, 4, 8), "vgg.31": (512, 2, 4)}),
    ((64, 32), 4, {"conv4_3": (512, 2, 4), "vgg.31": (512, 1, 2)}),
    ((80, 80), 2, {"conv4_3": (512, 5, 10), "vgg.23": (512, 5, 10)}),
    ((300, 300), 2, {"vgg.9": (128, 75, 150)}),
], ids=["64_s2", "64x32_s4", "80_s2", "300_s2"])
def test_ssd_local_spatial_forward_equals_one_device_and_jax(size, s, landed):
    jcfg, tcfg = cfg_pair(resize_img=size, mdl_to_use="ssd_vgg")
    variables = jax_variables(jcfg, VOCAB, seed=0)
    model = port_model(tcfg, variables, VOCAB)
    for b in ((s, 1) if size[0] == 300 else (s, 3)):
        batch = random_batch(np.random.default_rng(b), b, tcfg, VOCAB)
        with torch.inference_mode():
            one = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
        got, where = _spatial_forward(model, batch, s)
        assert where == {k: (b, *v) for k, v in landed.items()}, where
        for k in ("att_out", "bbx_out"):
            np.testing.assert_allclose(got[k].numpy(), one[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
        if b == s and size[0] != 300:
            want = jax.jit(lambda v, x: JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(v, x, train=False))(
                variables, {k: jnp.asarray(batch[k]) for k in ("img", "qvec", "qlens")})
            for k in ("att_out", "bbx_out"):
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, rtol=2e-3, err_msg=k)


def _same(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["box_norm"], b["box_norm"], atol=1e-5, rtol=0)
        assert abs(a["score"] - b["score"]) <= 1e-6


@pytest.mark.parametrize("quantize", [False, True], ids=["float32", "int8"])
def test_ssd_spatial_grounder_buckets_equal_one_device(quantize):
    jcfg, tcfg = cfg_pair(mdl_to_use="ssd_vgg")
    vocab = Vocab.build(QUERIES)
    sd = state_dict_from_jax(jax_variables(jcfg, len(vocab), seed=5), tcfg)
    imgs = list(np.random.default_rng(3).integers(0, 256, size=(4, 64, 64, 3)).astype(np.uint8))
    kw = dict(batch_size=32 if quantize else 4, bucket_sizes=(1, 2, 4), quantize=quantize)
    one = Grounder(tcfg, vocab, sd, device="cpu", **kw)
    g = Grounder(tcfg, vocab, sd, devices=["cpu", "cpu"], mesh_spatial=2, **kw)
    try:
        _same(g.ground(imgs, QUERIES[:4]), one.ground(imgs, QUERIES[:4]))  # int8: both calibrate here
        if quantize:
            scales = quant_scales(g.model)
            assert scales and scales.keys() == quant_scales(one.model).keys()
            for k, v in quant_scales(one.model).items():
                assert torch.equal(scales[k], v), k
        for n in (1, 2):
            _same(g.ground(imgs[:n], QUERIES[3:3 + n]), one.ground(imgs[:n], QUERIES[3:3 + n]))
    finally:
        g.local_mesh.close()
