"""The yardstick's arithmetic: model FLOPs against ``FlopCounterMode`` over
the reference at the published widths, the loss kernels' bytes against hand
sums, and the trace's idle union on a synthetic trace."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, harness
from benchmark.reference import model as ref_model
from benchmark.trace import parse
from benchmark.weights import make_state


@pytest.mark.parametrize("cell", ["retina300.train.b128", "ssd300.train.b128"])
def test_forward_flops_equal_the_flop_counter(cell):
    cfg = harness.load_cell(cell).config
    state = make_state(cfg, 50, 1, "cpu")
    qlen = 9
    qvec = torch.zeros((1, cfg["max_qlen"]), dtype=torch.int64)
    qvec[0, :qlen] = 3
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref_model.forward(cfg, state, torch.zeros((1, 300, 300, 3), dtype=torch.uint8), qvec, torch.tensor([qlen]))
    assert fc.get_total_flops() == counts.forward_flops(cfg, qlen)


def test_loss_kernel_bytes_by_hand():
    b, a, pos = 16, 17451, 31
    _, k1 = counts.k1_cost(b, a, pos)
    # logits 4·B·A, anchors' tlbr 16·A, deltas and centres at positives 32 each,
    # box and weight 20 a row, the sums 12, argmax 4 a row, partials 12 a row
    assert k1 == 1_116_864 + 279_216 + 992 + 320 + 12 + 64 + 192
    _, k2 = counts.k2_cost(b, a, pos)
    # K1's reads (argmax in, not out) and both gradients: 4·B·A + 16·B·A
    assert k2 == 1_116_864 + 279_216 + 992 + 384 + 12 + 1_116_864 + 4_467_456
    peaks = counts.PEAKS["NVIDIA H100 80GB HBM3"]
    assert counts.least_seconds(*counts.k2_cost(b, a, pos), peaks) == pytest.approx(k2 / 3.35e12)


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_idle_union_on_a_synthetic_trace():
    events = [
        _x("bench.stretch", "user_annotation", 0, 100),
        _x("k_a", "kernel", 10, 20), _x("k_b", "kernel", 15, 10),  # overlap: union 10..30
        _x("copy", "gpu_memcpy", 50, 10), _x("k_a", "kernel", 90, 20),  # clipped at 100
        _x("aten::item", "cpu_op", 28, 25), _x("cudaStreamSynchronize", "cuda_runtime", 29, 20),
        _x("aten::conv", "cpu_op", 60, 30), _x("outside", "kernel", 200, 5),
    ]
    tr = parse(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_intervals() == [(10, 30), (50, 60), (90, 100)]
    assert tr.busy_s == pytest.approx(40e-6)
    assert tr.device_seconds() == pytest.approx(60e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k_a", pytest.approx(40e-6)]
    # idle 0..10: nothing on the host; 30..50: the synchronize (29..49) inside
    # aten::item (28..53); 60..90: aten::conv
    gaps = dict((k, v) for k, v in bd["idle_gaps"])
    assert gaps == {"(no host operation)": pytest.approx(10e-6), "cudaStreamSynchronize": pytest.approx(19e-6),
                    "aten::item": pytest.approx(1e-6), "aten::conv": pytest.approx(30e-6)}
