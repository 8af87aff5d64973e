"""``torch.export`` serving artifacts on the CPU (64², float32,
fpn_ch/head_ch 16): each round trip answers as the live ``Grounder`` that
exported it — version 1, bucketed version 2 (the latency buckets through
the canvas head), version 3 with OOV slots and multi-query programs, and
int8 — with boxes within 1e-5 and scores within 1e-6 (the programs encode
queries with the masked scan, the live path with the packed LSTM; the two
agree to 1e-6). An uncalibrated int8 export is refused, each package
refuses the other's artifact, the daemon serves an artifact directory, and
the export CLI writes one from a checkpoint."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import QUERIES, cfg_pair, jax_variables, random_batch
from zsgnet_tpu.export import ExportedGrounder as JExportedGrounder
from zsgnet_tpu_torch import export
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data.vocab import Vocab
from zsgnet_tpu_torch.export import ExportedGrounder, export_serving
from zsgnet_tpu_torch.models.bilstm import encode_query, encode_query_masked
from zsgnet_tpu_torch.predict import Grounder
from zsgnet_tpu_torch.serve import load_server_model, make_server
from zsgnet_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = cfg_pair()
    return tcfg, state_dict_from_jax(jax_variables(jcfg, len(Vocab.build(QUERIES)), seed=8), tcfg)


def _images(n: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (64, 64, 3)).astype(np.uint8) for _ in range(n)]


def assert_same(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["box_norm"], b["box_norm"], atol=1e-5)
        np.testing.assert_allclose(a["box_xyxy"], b["box_xyxy"], atol=1e-3)
        assert abs(a["score"] - b["score"]) < 1e-6


def test_masked_query_encoder_equals_packed(weights):
    tcfg, sd = weights
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet

    model = ZSGNet(tcfg, sd["embedding.weight"].shape[0])
    model.load_state_dict(sd)
    batch = random_batch(np.random.default_rng(2), 6, tcfg, sd["embedding.weight"].shape[0])
    qvec, qlens = torch.from_numpy(batch["qvec"]), torch.from_numpy(batch["qlens"])
    qlens[:2] = torch.tensor([1, tcfg.max_qlen])
    with torch.no_grad():
        got = encode_query_masked(model.embedding, model.lstm, qvec, qlens)
        want = encode_query(model.embedding, model.lstm, qvec, qlens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_v1_round_trip_and_refusals(weights, tmp_path):
    tcfg, sd = weights
    vocab = Vocab.build(QUERIES)  # a Grounder with OOV slots adds words to its vocab
    g = Grounder(tcfg, vocab, sd, batch_size=4, device="cpu")  # the canvas head
    path = export_serving(g, tmp_path / "v1", platforms=("cpu",))
    meta = json.loads((path / "export.json").read_text())
    assert (meta["version"], meta["format"], meta["batch_size"]) == (1, "torch.export", 4)
    assert (path / "cpu" / "serving_fn.pt2").exists() and (path / "vocab.json").exists()
    eg = ExportedGrounder.load(path, device="cpu")
    assert eg.bucket_sizes == (4,) and eg.cfg == g.cfg
    images = _images(5)
    assert_same(eg.ground(images, QUERIES), g.ground(images, QUERIES))
    assert_same(eg.ground_image(images[0], QUERIES[:3]), g.ground_image(images[0], QUERIES[:3]))
    cuda_only = tmp_path / "cuda_only"
    cuda_only.mkdir()
    (cuda_only / "export.json").write_text(json.dumps({**meta, "platforms": ["cuda"]}))
    with pytest.raises(ValueError, match=r"holds programs for \['cuda'\], not cpu"):
        ExportedGrounder.load(cuda_only, device="cpu")
    # The JAX loader stops on this layout (no StableHLO module in it).
    with pytest.raises(FileNotFoundError, match="serving_fn.stablehlo"):
        JExportedGrounder.load(path)


def test_jax_artifact_is_refused(tmp_path):
    """A JAX artifact (export.json without "format") is refused by name."""
    (tmp_path / "export.json").write_text(json.dumps({"version": 3, "batch_size": 4, "platforms": ["cpu"]}))
    with pytest.raises(ValueError, match="not a torch.export artifact"):
        ExportedGrounder.load(tmp_path, device="cpu")


def test_v2_buckets_route_like_the_live_grounder(weights, tmp_path):
    """A batch-32 Grounder serves its bucket of 2 through the canvas head
    and 32 per level; the artifact's bucket programs do the same."""
    tcfg, sd = weights
    vocab = Vocab.build(QUERIES)  # a Grounder with OOV slots adds words to its vocab
    g = Grounder(tcfg, vocab, sd, batch_size=32, bucket_sizes=(2,), device="cpu")
    assert g.latency_canvas and g.canvas_for(2) and g.canvas_for(32) is None
    path = export_serving(g, tmp_path / "v2", platforms=("cpu",), bucket_sizes=(2,))
    assert json.loads((path / "export.json").read_text())["bucket_sizes"] == [2, 32]
    eg = ExportedGrounder.load(path, device="cpu")
    assert eg.bucket_sizes == (2, 32)
    images = _images(5, seed=1)
    for n in (2, 5):
        assert_same(eg.ground(images[:n], QUERIES[:n]), g.ground(images[:n], QUERIES[:n]))


@pytest.fixture(scope="module")
def v3(weights, tmp_path_factory):
    """Version 3 with 4 OOV slots and multi-query programs, buckets 1 and 2."""
    tcfg, sd = weights
    vocab = Vocab.build(QUERIES)  # a Grounder with OOV slots adds words to its vocab
    g = Grounder(tcfg, vocab, sd, batch_size=2, bucket_sizes=(1,), oov_slots=4, device="cpu")
    path = export_serving(g, tmp_path_factory.mktemp("v3"), platforms=("cpu",), bucket_sizes=(1,),
                          weights_as_args=True, multiquery=True)
    return g, path


def test_v3_oov_and_multiquery_round_trip(v3):
    g, path = v3
    meta = json.loads((path / "export.json").read_text())
    assert (meta["version"], meta["oov_slots"], meta["multiquery_buckets"]) == (3, 4, [1, 2])
    assert sorted(p.name for p in (path / "cpu").iterdir()) == [
        "serving_fn_b1.pt2", "serving_fn_b2.pt2", "serving_mq_b1.pt2", "serving_mq_b2.pt2"]
    with np.load(path / "weights.npz") as z:
        assert z["model.embedding.weight"].shape[0] == len(g.vocab) + 4
    # The programs read the weights from weights.npz and carry no copy.
    weights_mb = (path / "weights.npz").stat().st_size / 1e6
    assert weights_mb > 50 and all(p.stat().st_size / 1e6 < weights_mb / 10 for p in (path / "cpu").iterdir())
    eg = ExportedGrounder.load(path, device="cpu")
    images = _images(3, seed=2)
    unseen = ["the zorblax box", "a quuxify ellipse", "red box"]
    got = eg.ground(images, unseen)
    assert_same(got, g.ground(images, unseen))
    for w in ("zorblax", "quuxify"):
        i = eg.vocab.word_to_id[w]
        assert i == g.vocab.word_to_id[w] >= len(g.vocab) - 2
        assert torch.equal(eg.embedding_table[i], g.model.embedding.weight[i])
    assert_same(eg.ground_image(images[0], unseen), g.ground_image(images[0], unseen))


def test_int8_export_round_trip_and_uncalibrated_refusal(weights, tmp_path):
    tcfg, sd = weights
    vocab = Vocab.build(QUERIES)  # a Grounder with OOV slots adds words to its vocab
    g = Grounder(tcfg, vocab, sd, batch_size=32, bucket_sizes=(32,), quantize=True, device="cpu")
    with pytest.raises(ValueError, match="uncalibrated"):
        export_serving(g, tmp_path / "raw", platforms=("cpu",))
    images = _images(4, seed=3)
    want = g.ground(images, QUERIES[:4])  # calibrates on this batch
    path = export_serving(g, tmp_path / "int8", platforms=("cpu",))
    assert json.loads((path / "export.json").read_text())["quantized"]
    eg = ExportedGrounder.load(path, device="cpu")
    assert_same(eg.ground(images, QUERIES[:4]), want)


def test_daemon_serves_an_artifact_directory(v3):
    g, path = v3
    eg = load_server_model(path, device="cpu")
    assert isinstance(eg, ExportedGrounder) and eg.bs == 2
    with pytest.raises(ValueError, match="serves as exported"):
        load_server_model(path, cfg_overrides={"max_qlen": "4"}, device="cpu")
    eg.warmup(multiquery=True)
    srv = make_server(eg, port=0, window_ms=5.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    images = _images(1, seed=4)
    img_path = path / "q.png"
    Image.fromarray(images[0]).save(img_path)
    try:
        for payload in ({"query": "the red box", "image_path": str(img_path)},
                        {"queries": ["the red box", "a blue box"], "image_path": str(img_path)}):
            req = urllib.request.Request(url + "/ground", data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.loads(r.read())
            got = body["results"] if "queries" in payload else [body]
            queries = payload.get("queries", [payload.get("query")])
            assert_same(got, g.ground([images[0]] * len(queries), queries))
        with urllib.request.urlopen(url + "/statz", timeout=30) as r:
            assert json.loads(r.read())["requests"] == 3
    finally:
        srv.shutdown()
        srv.server_close()


def test_export_cli_from_a_checkpoint(weights, tmp_path, capsys):
    tcfg, sd = weights
    vocab = Vocab.build(QUERIES)  # a Grounder with OOV slots adds words to its vocab
    d = tmp_path / "ckpt"
    CheckpointManager(d).save(0, {"model": sd, "best_metric": -1.0})
    (d / "cfg.json").write_text(tcfg.replace(vocab_size=len(vocab)).dumps())
    vocab.save(d / "vocab.json")
    path = export.main([str(d), str(tmp_path / "art"), "--platforms=cpu", "--batch_size=2"])
    assert "exported ('cpu',) serving artifact" in capsys.readouterr().out
    images = _images(2, seed=5)
    live = Grounder.from_checkpoint(d, batch_size=2, device="cpu")
    assert_same(ExportedGrounder.load(path, device="cpu").ground(images, QUERIES[:2]),
                live.ground(images, QUERIES[:2]))
    with pytest.raises(SystemExit, match="calibration"):
        export.main([str(d), str(tmp_path / "q"), "--platforms=cpu", "--batch_size=32", "--quantize=true"])
    with pytest.raises(SystemExit, match="weights_as_args"):
        export.main([str(d), str(tmp_path / "o"), "--platforms=cpu", "--oov_slots=4"])
