"""The port's profiling and debug helpers (``zsgnet_tpu_torch/utils``)
against the JAX package's: ``flops_estimate`` equal to the float, ``Timer``
with the same summary, ``time_fn`` and ``profile_trace`` on the CPU, and
``assert_finite_tree``/``checked`` naming the same non-finite leaves."""

import json

import numpy as np
import pytest
import torch

from zsgnet_tpu.config import Config as JConfig
from zsgnet_tpu.utils import debug as j_debug
from zsgnet_tpu.utils import profiling as j_profiling
from zsgnet_tpu_torch import utils
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.utils.debug import assert_finite_tree, checked, non_finite_leaves

CFGS = {
    "default": {},
    "small": dict(resize_img=(64, 96), fpn_ch=16, head_ch=16, lstm_dim=8, emb_dim=8),
    "six_anchors_512": dict(resize_img=(512, 512), scales=(1.0, 2.0), ratios=(0.5, 1.0, 2.0)),
}


@pytest.mark.parametrize("name", list(CFGS))
def test_flops_estimate_equals_jax(name):
    assert utils.flops_estimate(Config(**CFGS[name])) == j_profiling.flops_estimate(JConfig(**CFGS[name]))


def test_timer_summary_matches_jax():
    t, j = utils.Timer(), j_profiling.Timer()
    for timer in (t, j):
        for name in ("decode", "decode", "collate"):
            with timer.section(name):
                pass
    assert t.summary().keys() == j.summary().keys() == {"decode", "collate"}
    for k, v in t.summary().items():
        assert v.keys() == j.summary()[k].keys() == {"total_s", "count", "mean_ms"}
        assert v["count"] == j.summary()[k]["count"]
    with pytest.raises(ValueError):
        with t.section("raises"):
            raise ValueError
    assert t.summary()["raises"]["count"] == 1  # timed though it raised


def test_time_fn_returns_seconds_and_output():
    calls = []
    secs, out = utils.time_fn(lambda x: calls.append(1) or x * 2, torch.ones(3), warmup=2, iters=5)
    assert len(calls) == 7 and secs >= 0.0
    torch.testing.assert_close(out, torch.full((3,), 2.0))


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with utils.profile_trace(tmp_path / "trace") as prof:
        (x @ x).sum()
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    assert prof.trace_path.parent == tmp_path / "trace"
    assert any("mm" in e.get("name", "") for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def _tree(bad):
    leaf = np.array([1.0, bad], np.float32)
    return {"a": {"w": np.ones(2, np.float32)}, "b": [np.zeros(1, np.float32), leaf],
            "c": np.array([1, 2], np.int32)}


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_assert_finite_tree_names_the_leaf_as_jax(bad):
    """Numpy trees get JAX's leaf names (``['b'][1]``); the same tree of
    tensors too."""
    with pytest.raises(FloatingPointError) as j_err:
        j_debug.assert_finite_tree(_tree(bad), "params")
    with pytest.raises(FloatingPointError) as t_err:
        assert_finite_tree(_tree(bad), "params")
    assert str(t_err.value) == str(j_err.value) == "non-finite values in params: [\"['b'][1]\"]"
    torch_tree = {"a": {"w": torch.ones(2)}, "b": [torch.zeros(1), torch.tensor([1.0, bad])]}
    assert non_finite_leaves(torch_tree) == ["['b'][1]"]
    assert_finite_tree(_tree(1.0))


def test_assert_finite_tree_on_a_state_dict():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.BatchNorm1d(2))
    assert_finite_tree(model.state_dict())
    with torch.no_grad():
        model[1].running_var[0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"\['1.running_var'\]"):
        assert_finite_tree(model.state_dict(), "model")
    assert non_finite_leaves(model) == ["['1.running_var']"]


def test_checked_raises_on_a_non_finite_output():
    def loss(x):
        return {"total": x.log().sum(), "n": torch.tensor(3)}

    assert float(checked(loss)(torch.ones(3))["total"]) == 0.0
    with pytest.raises(FloatingPointError, match=r"output of loss: \[\"\['total'\]\"\]"):
        checked(loss)(torch.tensor([1.0, -1.0]))
