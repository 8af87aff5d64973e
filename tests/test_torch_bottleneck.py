"""The port's fused bottleneck (K3's wrapper, plain version, ``fold_bn``,
``block_args``) against the JAX package on the CPU, at the JAX tests'
small shapes (B 2, H 11, W 9: odd sides, so the tiles' edges and conv2's
zero padding are exercised). The kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zsgnet_tpu.models.resnet import Bottleneck as JBottleneck
from zsgnet_tpu.ops.pallas import fused_bottleneck as jfb
from zsgnet_tpu_torch.convert import _bn, _conv
from zsgnet_tpu_torch.models.resnet import Bottleneck
from zsgnet_tpu_torch.ops.cuda import fused_bottleneck as fb
from zsgnet_tpu_torch.tools import bench_bottleneck

torch.set_num_threads(1)


def _mk(seed, B=2, H=11, W=9, Cin=16, Cmid=8, Cout=16, proj=False):
    """Numpy inputs in the recipe of tests/test_pallas_bottleneck.py."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)  # noqa: E731
    x = f(B, H, W, Cin)
    args = dict(w1=f(Cin, Cmid), s1=f(Cmid) + 1.0, b1=f(Cmid),
                w2=f(3, 3, Cmid, Cmid), s2=f(Cmid) + 1.0, b2=f(Cmid),
                w3=f(Cmid, Cout), s3=f(Cout) + 1.0, b3=f(Cout))
    if proj:
        args.update(wd=f(Cin, Cout), sd=f(Cout) + 1.0, bd=f(Cout))
    return x, args


def _torch(x, args, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype), {k: torch.from_numpy(v) for k, v in args.items()}


def _jax(x, args, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype), {k: jnp.asarray(v) for k, v in args.items()}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


CASES = [(False, "float32"), (True, "float32"), (False, "bfloat16"), (True, "bfloat16")]


@pytest.mark.parametrize("proj,dtype", CASES, ids=[f"{'proj' if p else 'identity'}-{d}" for p, d in CASES])
def test_plain_version_matches_jax_reference(proj, dtype):
    # atol/rtol 2e-2, as tests/test_pallas_bottleneck.py: bf16 rounding of
    # h1/h2 may flip on float32 sums taken in another order.
    x, args = _mk(1, Cout=32 if proj else 16, proj=proj)
    tx, targs = _torch(x, args, getattr(torch, dtype))
    jx, jargs = _jax(x, args, getattr(jnp, dtype))
    got = fb.bottleneck_infer_reference(tx, **targs)
    want = jfb.bottleneck_infer_reference(jx, **jargs)
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_wrapper_on_cpu_matches_pallas_kernel_in_interpret_mode(proj):
    # atol/rtol 2e-2, as the JAX test of the Pallas kernel against its oracle.
    x, args = _mk(2, Cout=32 if proj else 16, proj=proj)
    tx, targs = _torch(x, args)
    jx, jargs = _jax(x, args)
    launches = fb.fused_bottleneck_infer.launches
    got = fb.fused_bottleneck_infer(tx, **targs)
    assert fb.fused_bottleneck_infer.launches == launches  # the CPU runs no kernel
    with pltpu.force_tpu_interpret_mode():
        want = jfb.fused_bottleneck_infer(jx, **jargs)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def _flax_block(cin, cm, seed=0):
    """A flax Bottleneck in inference mode with BatchNorm statistics drawn
    from U(0.6, 1.4), as tests/test_pallas_bottleneck.py; → (module, params,
    stats) as numpy."""
    x0 = jnp.zeros((1, 9, 9, cin), jnp.float32)
    block = JBottleneck(features=cm, stride=1, dtype=jnp.float32)
    v = block.init(jax.random.PRNGKey(seed), x0, False)
    r2 = np.random.default_rng(seed + 1)
    stats = jax.tree.map(lambda a: r2.uniform(0.6, 1.4, a.shape).astype(np.float32), v["batch_stats"])
    params = jax.tree.map(np.asarray, v["params"])
    return block, params, stats


def _port_block(params, stats):
    """The port's eval Bottleneck carrying the flax weights, mapped by the
    converter's own conv and BatchNorm helpers (convert.state_dict_from_jax)."""
    cin, cm = params["conv1"]["kernel"].shape[2:]
    sd = {}
    for j in (1, 2, 3):
        sd[f"conv{j}.weight"] = _conv(params[f"conv{j}"]["kernel"])
        _bn(sd, f"bn{j}", params[f"bn{j}"], stats[f"bn{j}"])
    if "downsample_conv" in params:
        sd["downsample.0.weight"] = _conv(params["downsample_conv"]["kernel"])
        _bn(sd, "downsample.1", params["downsample_bn"], stats["downsample_bn"])
    block = Bottleneck(cin, cm)
    block.load_state_dict(sd)
    return block.eval()


BLOCKS = [(32, 8), (16, 8)]  # identity / projection, as tests/test_pallas_bottleneck.py


@pytest.mark.parametrize("cin,cm", BLOCKS, ids=["identity", "proj"])
def test_block_args_matches_flax_block(cin, cm):
    # atol/rtol 3e-2, as tests/test_pallas_bottleneck.py: the flax block in
    # float32 against bf16 operands.
    jblock, params, stats = _flax_block(cin, cm)
    x = np.random.default_rng(3).normal(size=(2, 11, 9, cin)).astype(np.float32)
    want = np.asarray(jblock.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), False))
    args = fb.block_args(_port_block(params, stats))
    assert ("wd" in args) == (cin != 4 * cm)
    got = fb.fused_bottleneck_infer(torch.from_numpy(x), **args)
    np.testing.assert_allclose(_np(got), want, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("cin,cm", BLOCKS, ids=["identity", "proj"])
def test_block_args_holds_the_eager_block_in_float32(cin, cm):
    # rtol 1e-5 (atol 1e-6 on outputs of order 1): the same float32 math in
    # another association (BatchNorm folded into scale and bias), so only a
    # wrong transpose of a weight could move it further.
    _, params, stats = _flax_block(cin, cm, seed=4)
    block = _port_block(params, stats)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 11, 9, cin)).astype(np.float32))
    args = fb.block_args(block)
    got = fb._bottleneck_math(x, **{k: args.get(k) for k in ("w1", "s1", "b1", "w2", "s2", "b2", "w3",
                                                             "s3", "b3", "wd", "sd", "bd")},
                              rnd=lambda t: t)
    with torch.no_grad():
        want = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(6)
    scale, bias, mean = (rng.normal(size=8).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, size=8).astype(np.float32)
    got = fb.fold_bn(*(torch.from_numpy(a) for a in (scale, bias, mean, var)))
    want = jfb.fold_bn(*(jnp.asarray(a) for a in (scale, bias, mean, var)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)  # float32


def test_block_args_refuses_a_strided_block():
    with pytest.raises(ValueError, match="stride 1"):
        fb.block_args(Bottleneck(64, 32, stride=2).eval())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_output_has_the_input_dtype(dtype):
    x, args = _mk(7, Cout=32, proj=True)
    tx, targs = _torch(x, args, dtype)
    out = fb.fused_bottleneck_infer(tx, **targs)
    assert out.dtype == dtype and tuple(out.shape) == (2, 11, 9, 32)
    assert bool((out >= 0).all())


def _bad(kind):
    x, args = _mk(8)
    tx, targs = _torch(x, args)
    if kind == "ndim":
        tx = tx[0]
    elif kind == "contiguous":
        tx = tx.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "dtype":
        tx = tx.half()
    elif kind == "identity_width":
        targs["w3"] = torch.zeros(8, 32)
        targs["s3"] = targs["b3"] = torch.zeros(32)
    elif kind == "partial_projection":
        targs["wd"] = torch.zeros(16, 16)
    return tx, targs


@pytest.mark.parametrize("kind,exc,match", [
    ("ndim", ValueError, "B, H, W, Cin"),
    ("contiguous", ValueError, "contiguous"),
    ("dtype", TypeError, "dtype"),
    ("identity_width", ValueError, "Cin == Cout"),
    ("partial_projection", ValueError, "wd, sd and bd"),
])
def test_wrapper_raises_on_what_it_does_not_take(kind, exc, match):
    tx, targs = _bad(kind)
    with pytest.raises(exc, match=match):
        fb.fused_bottleneck_infer(tx, **targs)


@pytest.mark.parametrize("proj", [False, True], ids=["identity", "proj"])
def test_bench_eager_block_is_the_same_function(proj):
    # float32 on the CPU, rtol 1e-4 / atol 1e-5: the bench's eager block
    # holds running_var 1 − eps, whose sqrt(var + eps) rounds within 1 ulp of 1.
    rng = np.random.default_rng(9)
    cin = 16 if proj else 32
    args = bench_bottleneck.random_args(rng, cin, 8, 32, proj, "cpu")
    x = torch.from_numpy(rng.normal(size=(2, 11, 9, cin)).astype(np.float32))
    with torch.no_grad():
        want = bench_bottleneck.eager_block(args)(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    got = fb._bottleneck_math(x, **{k: args.get(k) for k in ("w1", "s1", "b1", "w2", "s2", "b2",
                                                            "w3", "s3", "b3", "wd", "sd", "bd")},
                              rnd=lambda t: t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


# ResNet-50 layer1 widths (Cmid 64, Cout 256) at sides that leave ragged
# tiles on both axes of the Hopper kernel's 8 x 16 tiling, a batch of 1 and
# sides under one tile: the shapes the CUDA tests and chip_smoke.py hold the
# kernel to, here the plain version against the JAX reference.
LAYER1_RAGGED = {
    "identity-1x13x21": (1, 13, 21, 256, False),
    "projection-2x9x17": (2, 9, 17, 64, True),
    "identity-1x5x3": (1, 5, 3, 256, False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYER1_RAGGED))
def test_plain_version_matches_jax_reference_at_ragged_layer1_widths(name, dtype):
    # atol/rtol 2e-2, as tests/test_pallas_bottleneck.py (bf16 rounding of h1/h2).
    b, h, w, cin, proj = LAYER1_RAGGED[name]
    x, args = _mk(10, B=b, H=h, W=w, Cin=cin, Cmid=64, Cout=256, proj=proj)
    tx, targs = _torch(x, args, getattr(torch, dtype))
    jx, jargs = _jax(x, args, getattr(jnp, dtype))
    got = fb.fused_bottleneck_infer(tx, **targs)  # the wrapper: the plain version on the CPU
    want = jfb.bottleneck_infer_reference(jx, **jargs)
    assert got.dtype == tx.dtype and tuple(got.shape) == (b, h, w, 256)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def _layout_case(kind):
    """x of ResNet-50 layer1 width that the kernels' copies and tensor map
    cannot address, built on the CPU (the check reads only the tensor's
    address and strides)."""
    n = 2 * 5 * 7 * 64
    if kind == "misaligned-bf16":  # 2 bytes past a 16-byte boundary
        return torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(2, 5, 7, 64)
    if kind == "misaligned-float32":  # 4 bytes past
        return torch.zeros(n + 4, dtype=torch.float32)[1:n + 1].view(2, 5, 7, 64)
    if kind == "channel-stride":  # every other channel of a wider tensor
        return torch.zeros(2, 5, 7, 128, dtype=torch.bfloat16)[..., ::2]
    if kind == "pixel-stride":  # 64 of 68 channels kept: a pixel stride of 136 bytes
        return torch.zeros(2, 5, 7, 68, dtype=torch.bfloat16)[..., :64]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,match", [
    ("misaligned-bf16", "16-byte aligned"),
    ("misaligned-float32", "16-byte aligned"),
    ("channel-stride", "channels must be contiguous"),
    ("pixel-stride", "multiple of 16 bytes"),
])
def test_kernel_layout_check_raises(kind, match):
    x = _layout_case(kind)
    with pytest.raises(ValueError, match=match):
        fb._check_kernel_layout(x, 64, 64, 256)


def test_kernel_layout_check_passes_a_fresh_tensor():
    fb._check_kernel_layout(torch.zeros(2, 5, 7, 64, dtype=torch.bfloat16), 64, 64, 256)
    with pytest.raises(ValueError, match="multiples of 16"):
        fb._check_kernel_layout(torch.zeros(2, 5, 7, 24), 24, 8, 32)
