"""The port's SSD-VGG16 backbone and the ZSGNet built on it, against the
JAX package on the CPU in float32.

* ``ssd_feature_map_sizes`` equal to the JAX function's, and the port's
  maps of those sizes, at 64² (adaptive padding: 8, 4, 2, 1, 1, 1), 300²
  and an odd 97 × 123.
* The backbone's six maps against the JAX ``SSDVGG16`` on the same weights
  (native channels and ``uniform_proj``), atol 5e-4 / rtol 2e-3
  (tests/test_torch_model.py's budget), and against the amdegroot torch
  model of tests/test_convert_ssd.py at 300², whose ``state_dict`` the port
  loads unchanged: atol 1e-5 / rtol 1e-4 (float32, the same convolutions;
  the L2 norm's products in another order).
* The JAX converter ``convert_vgg16_ssd`` maps the port's backbone
  ``state_dict`` back onto the JAX params exactly.
* ZSGNet with ``mdl_to_use="ssd_vgg"`` (per-level heads on the native
  channels, or one shared head after ``uniform_proj``) against the JAX
  ZSGNet: atol 5e-4 / rtol 2e-3; its anchor pyramid equals the JAX one.
* ``L2Norm`` computes in float32 under bf16 autocast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_port import cfg_pair, jax_variables, port_model, random_batch
from test_convert_ssd import TorchSSDVGG
from zsgnet_tpu.convert.torch_import import convert_vgg16_ssd
from zsgnet_tpu.models import ssd_vgg as j_ssd
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu.models.zsgnet import anchor_pyramid_for as j_anchor_pyramid
from zsgnet_tpu_torch.convert import ssd_backbone_from_jax
from zsgnet_tpu_torch.models.ssd_vgg import L2Norm, SSDVGG16, ssd_feature_map_sizes
from zsgnet_tpu_torch.models.zsgnet import anchor_pyramid_for

torch.set_num_threads(1)

VOCAB = 30


def _image(hw, seed=0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=(1, *hw, 3)) * 0.5).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


@pytest.mark.parametrize("hw", [(64, 64), (300, 300), (97, 123)], ids=["64", "300", "97x123"])
def test_feature_map_sizes_match_jax(hw):
    sizes = ssd_feature_map_sizes(hw)
    assert sizes == j_ssd.ssd_feature_map_sizes(hw)
    if hw == (64, 64):
        assert sizes == ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1), (1, 1))
    if hw == (300, 300):
        return  # the 300² maps are checked against the amdegroot model below
    with torch.no_grad():
        maps = SSDVGG16().eval()(_nchw(_image(hw)))
    assert tuple(tuple(m.shape[2:]) for m in maps) == sizes
    assert tuple(m.shape[1] for m in maps) == (512, 1024, 512, 256, 256, 256)


def _jax_backbone(uniform_proj: bool, hw=(64, 64)):
    """A JAX SSDVGG16 (out_ch 16) with every weight perturbed, its params
    as numpy, and a seeded input."""
    model = j_ssd.SSDVGG16(out_ch=16, uniform_proj=uniform_proj, dtype=jnp.float32)
    x = _image(hw)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda p: np.asarray(p) + rng.normal(0, 0.02, np.shape(p)).astype(np.float32), params)
    return model, params, x


@pytest.mark.parametrize("uniform_proj", [False, True], ids=["native", "uniform_proj"])
def test_backbone_matches_jax(uniform_proj):
    jmodel, params, x = _jax_backbone(uniform_proj)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    model = SSDVGG16(16, uniform_proj=uniform_proj).eval()
    model.load_state_dict(ssd_backbone_from_jax(params, prefix=""))
    with torch.no_grad():
        got = model(_nchw(x))
    assert len(got) == len(want) == 6
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).transpose(0, 3, 1, 2),
                                   atol=5e-4, rtol=2e-3, err_msg=f"level {lvl}")


def test_backbone_matches_the_amdegroot_model_at_300():
    oracle = TorchSSDVGG().eval()
    model = SSDVGG16().eval()
    model.load_state_dict(oracle.state_dict())  # the same names, strict
    x = _nchw(_image((300, 300), seed=2))
    with torch.no_grad():
        want, got = oracle(x), model(x)
    assert tuple(tuple(m.shape[1:]) for m in got) == tuple(
        (c, *hw) for c, hw in zip((512, 1024, 512, 256, 256, 256), ssd_feature_map_sizes((300, 300))))
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-4, err_msg=f"level {lvl}")


def test_jax_converter_maps_port_weights_back():
    _, params, _ = _jax_backbone(False)
    model = SSDVGG16(16)
    model.load_state_dict(ssd_backbone_from_jax(params, prefix=""))
    back = traverse_util.flatten_dict(convert_vgg16_ssd(model.state_dict()))
    want = traverse_util.flatten_dict(params)
    assert set(back) == set(want)
    for k, x in want.items():
        np.testing.assert_array_equal(back[k], x, err_msg=str(k))


@pytest.mark.parametrize("uniform_proj", [False, True], ids=["native_heads", "uniform_proj_shared_head"])
def test_zsgnet_ssd_forward_matches_jax(uniform_proj):
    jcfg, tcfg = cfg_pair(mdl_to_use="ssd_vgg", ssd_uniform_proj=uniform_proj)
    variables = jax_variables(jcfg, VOCAB, seed=0)
    assert ("head" in variables["params"]) == uniform_proj
    batch = random_batch(np.random.default_rng(9), 3, tcfg, VOCAB)
    apply = jax.jit(lambda v, b: JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(v, b, train=False))
    want = apply(variables, {k: jnp.asarray(batch[k]) for k in ("img", "qvec", "qlens")})
    model = port_model(tcfg, variables, VOCAB)
    assert hasattr(model, "heads") != uniform_proj
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
    anchors = anchor_pyramid_for(tcfg)
    np.testing.assert_array_equal(anchors, j_anchor_pyramid(jcfg))
    assert got["att_out"].shape == (3, anchors.shape[0]) == (3, 783)
    assert got["feat_sizes"] == tuple(tuple(s) for s in want["feat_sizes"])
    np.testing.assert_allclose(got["att_out"].numpy(), np.asarray(want["att_out"]), atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(got["bbx_out"].numpy(), np.asarray(want["bbx_out"]), atol=5e-4, rtol=2e-3)


def test_ssd_anchor_count_at_300():
    _, tcfg = cfg_pair(mdl_to_use="ssd_vgg", resize_img=(300, 300))
    assert anchor_pyramid_for(tcfg).shape == (17460, 4)


def test_l2norm_is_float32_under_bf16_autocast():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 8, 3, 3)).astype(np.float32))
    norm = L2Norm(8)
    with torch.no_grad():
        norm.weight.uniform_(10.0, 30.0)
        xb = x.to(torch.bfloat16)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = norm(xb)
        x64 = xb.double()
        want = x64 / torch.sqrt((x64 * x64).sum(1, keepdim=True) + 1e-10) * norm.weight.double()[None, :, None, None]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.float().to(torch.bfloat16))
