"""Open-vocabulary serving and GloVe initialization in the port, against
the JAX package (the serving cases of tests/test_oov.py and
tests/test_embeddings.py): with ``oov_slots`` unseen query words get
distinct rows — the word's GloVe row, else one drawn from a generator
seeded with its CRC-32 — bit-identical to the JAX Grounder's; without
slots they collapse onto ``<unk>``. ``load_embedding_table`` gives the JAX
table bit for bit, and a Learner with ``glove_path`` starts from it."""

import numpy as np
import pytest
import torch

from _torch_port import cfg_pair, jax_variables
from zsgnet_tpu.data.embeddings import load_embedding_table as j_load_embedding_table
from zsgnet_tpu.data.vocab import Vocab as JVocab
from zsgnet_tpu.predict import Grounder as JGrounder
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data import synthetic
from zsgnet_tpu_torch.data.dataset import get_data
from zsgnet_tpu_torch.data.embeddings import load_embedding_table
from zsgnet_tpu_torch.data.vocab import PAD_ID, Vocab
from zsgnet_tpu_torch.predict import Grounder
from zsgnet_tpu_torch.train.learner import Learner

torch.set_num_threads(1)

WORDS = "the red box on the left"
ZERO = np.zeros((64, 64, 3), np.uint8)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = cfg_pair()
    variables = jax_variables(jcfg, len(Vocab.build([WORDS])), seed=4)
    return jcfg, tcfg, variables, state_dict_from_jax(variables, tcfg)


def _grounder(weights, oov_slots=0, glove_path=None):
    _, tcfg, _, sd = weights
    return Grounder(tcfg, Vocab.build([WORDS]), sd, batch_size=1, oov_slots=oov_slots,
                    glove_path=glove_path, device="cpu")


def _row(g, word):
    return g.model.embedding.weight[g.vocab.word_to_id[word]].detach().numpy()


def _glove(tmp_path):
    vec = np.arange(1, 9, dtype=np.float32) / 10.0
    path = tmp_path / "glove.txt"
    path.write_text("zorblax " + " ".join(f"{v:.1f}" for v in vec) + "\n"
                    "other 9 9 9 9 9 9 9 9\n")
    return path, vec


def test_without_slots_unseen_words_collapse_onto_unk(weights):
    g = _grounder(weights)
    (r1,) = g.ground([ZERO], ["zorblax"])
    (r2,) = g.ground([ZERO], ["quuxify"])
    assert r1 == r2 and len(g.vocab) == len(Vocab.build([WORDS]))


def test_oov_rows_are_distinct_deterministic_and_the_jax_rows(weights, tmp_path):
    """The same unseen words through both Grounders take the same ids and
    bit-identical rows (a GloVe row, then two hashed rows)."""
    jcfg, _, variables, _ = weights
    glove, _ = _glove(tmp_path)
    g = _grounder(weights, oov_slots=4, glove_path=glove)
    jg = JGrounder(jcfg, JVocab.build([WORDS]), variables, batch_size=1, oov_slots=4, glove_path=glove)
    base = len(g.vocab)
    queries = ["zorblax", "quuxify", "the gronkle", "zorblax"]
    got = [g.ground([ZERO], [q])[0] for q in queries]
    for q in queries:
        jg.ground([ZERO], [q])
    assert g.vocab.word_to_id == jg.vocab.word_to_id and len(g.vocab) == base + 3
    for w in ("zorblax", "quuxify", "gronkle"):
        np.testing.assert_array_equal(_row(g, w), jg._emb_host[jg.vocab.word_to_id[w]])
    assert not np.array_equal(_row(g, "quuxify"), _row(g, "gronkle"))
    assert got[0]["score"] != got[1]["score"] and got[3] == got[0]  # sticky assignment
    assert g.model.embedding.weight.shape[0] == base + 4  # padded once, never rebuilt


def test_oov_glove_row_is_used_verbatim(weights, tmp_path):
    glove, vec = _glove(tmp_path)
    g = _grounder(weights, oov_slots=2, glove_path=glove)
    g.ground([ZERO], ["zorblax"])
    np.testing.assert_array_equal(_row(g, "zorblax"), vec)
    g.ground_image(ZERO, ["quuxify"])  # absent from the file: a hashed row, not zeros
    assert np.abs(_row(g, "quuxify")).max() > 0


def test_oov_slot_exhaustion_falls_back_to_unk(weights, capsys):
    g = _grounder(weights, oov_slots=1)
    base = len(g.vocab)
    g.ground([ZERO], ["zorblax quuxify"])  # the second word finds the slots full
    assert len(g.vocab) == base + 1
    assert "OOV slots" in capsys.readouterr().out
    (r_q,) = g.ground([ZERO], ["quuxify"])
    (r_u,) = g.ground([ZERO], ["gronkle"])
    assert r_q == r_u


def test_oov_rejects_prepadded_table(weights):
    _, tcfg, _, sd = weights
    g = _grounder(weights, oov_slots=2)
    with pytest.raises(ValueError, match="OOV slots"):
        Grounder(tcfg, g.vocab, g.model.state_dict(), batch_size=1, oov_slots=2, device="cpu")
    assert "embedding.weight" in sd and sd["embedding.weight"].shape[0] == len(Vocab.build([WORDS]))


def test_oov_ignores_tokens_past_max_qlen(weights):
    g = _grounder(weights, oov_slots=2)
    g.ground([ZERO], [" ".join(["the"] * g.cfg.max_qlen) + " zorblax"])
    assert "zorblax" not in g.vocab.word_to_id


@pytest.mark.parametrize("header", [False, True], ids=["glove", "word2vec_header"])
def test_load_embedding_table_matches_jax(tmp_path, header):
    queries = ["the red box", "a blue cat", "red zebra"]
    rows = [("red", [1.0, 2.0, 3.0]), ("blue", [4.0, 5.0, 6.0]), ("zebra", [7.5, 8.0, 9.0]),
            ("red", [0.0, 0.0, 0.0]), ("short", [1.0])]
    path = tmp_path / "glove.txt"
    path.write_text(("4 3\n" if header else "") + "\n".join(
        f"{w} " + " ".join(str(v) for v in vec) for w, vec in rows))
    got, found = load_embedding_table(path, Vocab.build(queries), 3, seed=5)
    want, j_found = j_load_embedding_table(path, JVocab.build(queries), 3, seed=5)
    assert got.dtype == want.dtype == np.float32 and found == j_found == 4
    np.testing.assert_array_equal(got, want)
    assert not got[PAD_ID].any()


def test_learner_starts_from_the_glove_table(tmp_path, capsys):
    root = tmp_path / "data"
    synthetic.generate(root, n_train=4, n_val=4, n_test=4, img_size=64)
    _, tcfg = cfg_pair()
    cfg = tcfg.replace(ds_to_use="synthetic", data_dir=str(root), tmp_path=str(tmp_path / "tmp"),
                       bs=4, nw=1, ema_decay=0.5)
    data = get_data(cfg)
    path = tmp_path / "glove.txt"
    path.write_text("red " + " ".join(["0.5"] * cfg.emb_dim) + "\n"
                    "box " + " ".join(["-1.25"] * cfg.emb_dim) + "\n")
    learn = Learner("glove", data, cfg.replace(glove_path=str(path)), device="cpu")
    table, found = load_embedding_table(path, data.vocab, cfg.emb_dim, cfg.seed)
    assert f"glove init: {found}/{len(data.vocab)} vocab words found" in capsys.readouterr().out
    assert found == 2
    assert torch.equal(learn.model.embedding.weight.detach(), torch.from_numpy(table))
    assert torch.equal(learn.state.ema["embedding.weight"], torch.from_numpy(table))
