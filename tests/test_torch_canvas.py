"""The canvas head in the port against the port's per-level head and the
JAX model with ``head_canvas=True`` (64², float32, fpn_ch/head_ch 16):

* ``pack_levels`` and the canvas's grid and occupancy equal the JAX
  package's (exact) for the retina and SSD pyramids at 64² and 300²;
* the port with the canvas equals the port without it to 1e-5 (the same
  convolutions over the same values: only the summation order of cuDNN or
  the CPU's conv may differ), for a flat batch, a batch-1 image against
  4 queries, and grouped Q = 3 input;
* the port with the canvas equals the JAX model with ``head_canvas=True``
  on converted weights within atol 5e-4 / rtol 2e-3, the budget of
  tests/test_torch_model.py for the whole model across the two packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cfg_pair, grouped_batch, jax_variables, port_model, random_batch
from zsgnet_tpu.models import canvas as j_canvas
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu.models.zsgnet import pyramid_sizes_for as j_pyramid_sizes_for
from zsgnet_tpu_torch.models import canvas
from zsgnet_tpu_torch.models.zsgnet import pyramid_sizes_for

torch.set_num_threads(1)

VOCAB = 30


@pytest.mark.parametrize("mdl,size", [("retina", 64), ("retina", 300), ("ssd_vgg", 96), ("ssd_vgg", 300)])
def test_layout_and_constants_match_jax(mdl, size):
    jcfg, tcfg = cfg_pair(mdl_to_use=mdl, resize_img=(size, size))
    sizes = pyramid_sizes_for(tcfg)
    assert sizes == tuple(tuple(s) for s in j_pyramid_sizes_for(jcfg))
    layout, want = canvas.pack_levels(sizes), j_canvas.pack_levels(sizes)
    assert (layout.height, layout.width, layout.offsets, layout.sizes) == (
        want.height, want.width, want.offsets, want.sizes)
    got_c, want_c = canvas.canvas_constants(layout), j_canvas.canvas_constants(want)
    for k in ("grid", "occupancy"):
        np.testing.assert_array_equal(got_c[k], want_c[k])
    if size == 300:
        assert (layout.height, layout.width) == (38, 62)


def test_pack_levels_refuses_unsorted_levels():
    with pytest.raises(ValueError, match="sorted"):
        canvas.pack_levels([(4, 4), (8, 8)])


def _inputs(kind: str, tcfg):
    rng = np.random.default_rng(7)
    if kind == "grouped":
        batch = grouped_batch(rng, tcfg, 2, 3, VOCAB)
    else:
        batch = random_batch(rng, 4, tcfg, VOCAB)
        if kind == "multiquery":
            batch["img"] = batch["img"][:1]
    return {k: batch[k] for k in ("img", "qvec", "qlens")}


CASES = ["flat", "multiquery", "grouped"]


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = cfg_pair()
    variables = jax_variables(jcfg, VOCAB, seed=3)
    return jcfg, tcfg, variables, port_model(tcfg.replace(head_canvas=True), variables, VOCAB)


@pytest.mark.parametrize("kind", CASES)
def test_canvas_equals_per_level_in_the_port(setup, kind):
    _, tcfg, _, model = setup
    batch = {k: torch.from_numpy(v) for k, v in _inputs(kind, tcfg).items()}
    with torch.no_grad():
        got = model(**batch)
        want = model(**batch, canvas=False)
    assert got["feat_sizes"] == want["feat_sizes"]
    for k in ("att_out", "bbx_out"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", CASES)
def test_canvas_matches_jax_canvas(setup, kind):
    jcfg, tcfg, variables, model = setup
    batch = _inputs(kind, tcfg)
    jcfg = jcfg.replace(head_canvas=True)
    if kind == "multiquery":  # the JAX model broadcasts a batch-1 image the same way
        want = JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(variables, {k: jnp.asarray(v) for k, v in batch.items()})
    else:
        want = jax.jit(lambda v, b: JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(v, b))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
    for k in ("att_out", "bbx_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, rtol=2e-3)


def test_canvas_is_not_used_by_per_level_heads():
    """``use_same_atb=False`` has no shared head: ``head_canvas`` is
    ignored, as in the JAX model."""
    _, tcfg = cfg_pair(use_same_atb=False, head_canvas=True)
    from zsgnet_tpu_torch.models.zsgnet import get_default_net

    model = get_default_net(tcfg, VOCAB, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _inputs("flat", tcfg).items()}
    with torch.no_grad():
        a, b = model(**batch), model(**batch, canvas=False)
    assert torch.equal(a["att_out"], b["att_out"])
