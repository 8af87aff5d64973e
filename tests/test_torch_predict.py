"""The port's ``Grounder`` against the JAX ``Grounder`` on the same weights
and random (non-constant) images: boxes to 1e-4 normalized (1e-2 pixels),
scores to 1e-5, one result per request, across a chunk boundary. The JAX
Grounder at batch 4 serves through its canvas head, an exact
reparameterization of the port's per-level head, so the two agree to
float32 tolerance. Flat decode (the port) and the JAX per-level decode
differ only on tied scores, which random images do not produce."""

import numpy as np
import pytest
import torch

from _torch_port import QUERIES, cfg_pair, jax_variables
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu.predict import Grounder as JGrounder
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.predict import Grounder, chunk_results, prep_chunk

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def grounders():
    jcfg, tcfg = cfg_pair()
    vocab = Vocab.build(QUERIES)
    variables = jax_variables(jcfg, len(vocab), seed=2)
    jg = JGrounder(jcfg, JVocab.build(QUERIES), variables, batch_size=4, bucket_sizes=(4,))
    tg = Grounder(tcfg, vocab, state_dict_from_jax(variables, tcfg), batch_size=4, device="cpu")
    return jg, tg


def test_ground_matches_jax(grounders):
    jg, tg = grounders
    rng = np.random.default_rng(13)
    images = [rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8) for _ in QUERIES]
    queries = QUERIES[::-1]
    got = tg.ground(images, queries)
    want = jg.ground(images, queries)
    assert len(got) == len(want) == len(QUERIES)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["box_norm"], w["box_norm"], atol=1e-4)
        np.testing.assert_allclose(g["box_xyxy"], w["box_xyxy"], atol=1e-2)
        assert abs(g["score"] - w["score"]) < 1e-5
        assert np.all(np.abs(g["box_norm"]) <= 1.0)


def test_ground_from_image_files(grounders, tmp_path):
    """Paths decode with PIL at their original size; pixel boxes use it."""
    from PIL import Image

    _, tg = grounders
    rng = np.random.default_rng(14)
    arr = rng.integers(0, 256, size=(48, 80, 3)).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.png")
    (res,) = tg.ground([tmp_path / "a.png"], ["the red box"])
    y1, x1, y2, x2 = res["box_norm"]
    np.testing.assert_allclose(res["box_xyxy"], [(x1 + 1) * 40, (y1 + 1) * 24,
                                                 (x2 + 1) * 40, (y2 + 1) * 24], rtol=1e-6)
    assert tg.ground([], []) == []
    with pytest.raises(ValueError, match="pair up"):
        tg.ground([arr], [])


def test_prep_chunk_pads_with_length_one_rows():
    _, tcfg = cfg_pair()
    vocab = Vocab.build(QUERIES)
    img = np.full((64, 64, 3), 7, np.uint8)
    imgs, qvec, qlens, sizes, k = prep_chunk(tcfg, vocab, 4, [img], ["the red box"])
    assert k == 1 and imgs.shape == (4, 64, 64, 3) and qlens.tolist() == [3, 1, 1, 1]
    assert (imgs[1:] == 0).all() and (qvec[1:] == 0).all()
    res = chunk_results(np.zeros((4, 4)), np.full(4, 0.5), sizes, k)
    assert res == [{"box_norm": [0.0] * 4, "box_xyxy": [32.0] * 4, "score": 0.5}]
