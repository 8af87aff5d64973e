"""The port's ZSGNet against the JAX ZSGNet on the same weights: a random
JAX init (biases and BatchNorm statistics perturbed) goes through
``state_dict_from_jax`` into the port, and both forward the same seeded
batch in float32 on the CPU (atol 5e-4, rtol 2e-3, the budget of
tests/test_convert_full.py), at 64² (C3/C4/C5 8/4/2: integer top-down
ratios) and at 80² (10/5/3: the FPN's nearest upsample maps 3 → 5 and
5 → 10, the non-integer case of 300²'s 10 → 19). The JAX package's own
converter maps the port's ``state_dict`` back onto the JAX params exactly.

A JAX ``spd_stem=True`` model (its space-to-depth stem is an exact rewrite
of the 7×7/2 conv, which the port always runs) agrees with the port within
1e-5; under ``mesh_spatial=2`` the port enters such a model by the reshard
at the input, as the JAX ``ResNet50`` does, and agrees as well."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from _torch_port import cfg_pair, jax_variables, port_model, random_batch
from zsgnet_tpu.convert.torch_import import convert_zsgnet_checkpoint
from zsgnet_tpu.models.bilstm import BiLSTMEncoder as JBiLSTM
from zsgnet_tpu.models.zsgnet import ZSGNet as JZSGNet
from zsgnet_tpu_torch.convert import ungroup_head_channels
from zsgnet_tpu_torch.models.bilstm import encode_query, fold_lstm_bias_, make_encoder
from zsgnet_tpu_torch.models.zsgnet import FOCAL_PRIOR_BIAS, ZSGNet, init_weights
from zsgnet_tpu_torch.parallel.halo import LocalMesh

torch.set_num_threads(1)

VOCAB = 30


@functools.lru_cache(maxsize=None)
def _setup(size: tuple[int, int]):
    jcfg, tcfg = cfg_pair(resize_img=size)
    variables = jax_variables(jcfg, VOCAB, seed=0)
    return jcfg, tcfg, variables, port_model(tcfg, variables, VOCAB)


@pytest.fixture(scope="module")
def setup():
    return _setup((64, 64))


@pytest.mark.parametrize("size,n_anchors", [((64, 64), 774), ((80, 80), 1251)], ids=["64", "80"])
def test_forward_matches_jax(size, n_anchors):
    jcfg, tcfg, variables, model = _setup(size)
    batch = random_batch(np.random.default_rng(7), 3, tcfg, VOCAB)
    batch["qlens"][:] = (1, 5, tcfg.max_qlen)
    want = JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(
        variables, {k: jnp.asarray(batch[k]) for k in ("img", "qvec", "qlens")}, train=False
    )
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
    assert got["att_out"].shape == (3, n_anchors) and got["bbx_out"].shape == (3, n_anchors, 4)
    assert got["feat_sizes"] == tuple(tuple(s) for s in want["feat_sizes"])
    np.testing.assert_allclose(got["att_out"].numpy(), np.asarray(want["att_out"]),
                               atol=5e-4, rtol=2e-3)
    np.testing.assert_allclose(got["bbx_out"].numpy(), np.asarray(want["bbx_out"]),
                               atol=5e-4, rtol=2e-3)


@functools.lru_cache(maxsize=None)
def _spd_setup():
    jcfg, tcfg = cfg_pair(spd_stem=True)
    variables = jax_variables(jcfg, VOCAB, seed=0)
    assert "conv1_kernel" in variables["params"]["backbone"]  # the space-to-depth stem
    batch = random_batch(np.random.default_rng(9), 4, tcfg, VOCAB)
    want = jax.jit(lambda v, x: JZSGNet(cfg=jcfg, vocab_size=VOCAB).apply(v, x, train=False))(
        variables, {k: jnp.asarray(batch[k]) for k in ("img", "qvec", "qlens")})
    return port_model(tcfg, variables, VOCAB), batch, want


def test_spd_stem_forward_matches_jax():
    model, batch, want = _spd_setup()
    with torch.no_grad():
        got = model(*(torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens")))
    for k in ("att_out", "bbx_out"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)


def test_spd_stem_enters_spatial_by_the_reshard():
    model, batch, want = _spd_setup()
    img, qv, ql = (torch.from_numpy(batch[k]) for k in ("img", "qvec", "qlens"))
    mesh = LocalMesh([torch.device("cpu")] * 2, 2)
    try:
        (members,) = mesh.run(lambda d, ctx: (model(ctx.rows(img), qv, ql, spatial=ctx), ctx.landed))
    finally:
        mesh.close()
    for _, landed in members:
        assert list(landed) == ["spd_stem"] and landed["spd_stem"] == (4, 3, 32, 64)
    for k in ("att_out", "bbx_out"):
        got = torch.cat([out[k] for out, _ in members])
        np.testing.assert_allclose(got.numpy(), np.asarray(want[k]), atol=1e-5, rtol=0, err_msg=k)


def test_jax_converter_maps_port_weights_back(setup):
    _, tcfg, variables, model = setup
    back = convert_zsgnet_checkpoint(
        model.state_dict(),
        head_conv_prefixes=("head.conv0", "head.conv1", "head.conv2", "head.conv3", "head.out"),
        num_anchors=tcfg.num_anchors,
    )
    for coll in ("params", "batch_stats"):
        want = traverse_util.flatten_dict(variables[coll])
        got = traverse_util.flatten_dict(back[coll])
        assert set(got) == set(want), coll
        for path, x in want.items():
            np.testing.assert_allclose(got[path], x, rtol=1e-6, atol=1e-7, err_msg=str(path))


def test_bilstm_matches_jax():
    rng = np.random.default_rng(8)
    emb, lstm = make_encoder(VOCAB, 8, 6)
    jenc = JBiLSTM(vocab_size=VOCAB, emb_dim=8, hidden=6)
    qvec = rng.integers(1, VOCAB, size=(5, 7)).astype(np.int32)
    qlens = np.array([1, 7, 3, 4, 2], np.int32)
    params = jenc.init(jax.random.PRNGKey(1), qvec, qlens)["params"]
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.1, np.shape(x)).astype(np.float32), params)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(params["embed"]["embedding"]))
        for d, sfx in (("fwd", "l0"), ("bwd", "l0_reverse")):
            getattr(lstm, f"weight_ih_{sfx}").copy_(torch.from_numpy(params[d]["w_ih"].T))
            getattr(lstm, f"weight_hh_{sfx}").copy_(torch.from_numpy(params[d]["w_hh"].T))
            getattr(lstm, f"bias_ih_{sfx}").copy_(torch.from_numpy(params[d]["bias"]))
            getattr(lstm, f"bias_hh_{sfx}").zero_()
        got = encode_query(emb, lstm, torch.from_numpy(qvec), torch.from_numpy(qlens))
    want = jenc.apply({"params": params}, qvec, qlens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_head_channel_ungroup_inverts_jax_regroup():
    from zsgnet_tpu.convert.torch_import import regroup_head_kernel

    rng = np.random.default_rng(9)
    k = rng.normal(size=(3, 3, 4, 45)).astype(np.float32)
    b = rng.normal(size=(45,)).astype(np.float32)
    k2, b2 = regroup_head_kernel(*ungroup_head_channels(k, b, 9), 9)
    np.testing.assert_array_equal(k2, k)
    np.testing.assert_array_equal(b2, b)


def test_init_weights_is_seeded_and_sets_the_focal_prior():
    _, tcfg = cfg_pair()
    a, b, c = (init_weights(ZSGNet(tcfg, VOCAB), seed=s) for s in (0, 0, 1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["head.conv0.weight"], sc["head.conv0.weight"])
    np.testing.assert_allclose(sa["head.out.bias"][0::5].numpy(), FOCAL_PRIOR_BIAS)
    assert float(sa["head.out.bias"][1::5].abs().max()) == 0.0


def test_init_weights_folds_the_lstm_bias():
    """The port's own init keeps bias_hh at 0 (its draw moved into bias_ih),
    and fold_lstm_bias_ leaves the encoder's output as it was."""
    _, tcfg = cfg_pair()
    model = init_weights(ZSGNet(tcfg, VOCAB), seed=3)
    for sfx in ("l0", "l0_reverse"):
        assert float(getattr(model.lstm, f"bias_hh_{sfx}").abs().max()) == 0.0
        assert float(getattr(model.lstm, f"bias_ih_{sfx}").detach().abs().max()) > 0.0
    rng = np.random.default_rng(10)
    emb, lstm = make_encoder(VOCAB, 8, 6)
    qvec = torch.from_numpy(rng.integers(1, VOCAB, size=(4, 7)))
    qlens = torch.tensor([1, 7, 3, 5])
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(torch.from_numpy(rng.uniform(-0.4, 0.4, p.shape).astype(np.float32)))
        want = encode_query(emb, lstm, qvec, qlens)
        sd = fold_lstm_bias_(lstm.state_dict(), prefix="")
        assert float(sd["bias_hh_l0"].abs().max()) == 0.0
        lstm.load_state_dict(sd)
        got = encode_query(emb, lstm, qvec, qlens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)  # float32, one add moved
