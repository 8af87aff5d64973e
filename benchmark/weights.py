"""Seeded weights for both sides of the comparison, made where they are used.

One ``torch.Generator`` on the target device draws every normal weight in
one call and every uniform one in another; each tensor is then a scaled
view of those draws: LeCun-normal convolutions (σ = 1/√fan_in) with zero
biases, N(0, 1) embeddings, U(±1/√H) LSTM weights and biases, identity
BatchNorm (weight 1, bias 0, running mean 0, variance 1) but for the last
BatchNorm of each residual branch, whose scale is the configuration's
``init.residual_bn_scale`` (1 without it), L2Norm's scale of 20, and the
focal prior −log(99) on every head's score biases. The names
and shapes come from the reference's ``param_shapes``, which names them as
the system under test does.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.model import param_shapes

Tensor = torch.Tensor

FOCAL_PRIOR = -math.log(99.0)


def make_state(cfg: dict, vocab_size: int, seed: int, device: str | torch.device,
               dtype: torch.dtype = torch.float32) -> dict[str, Tensor]:
    spec = param_shapes(cfg, vocab_size)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**64)
    normal = [(n, s) for n, (k, s) in spec.items() if k in ("conv", "emb")]
    uniform = [(n, s) for n, (k, s) in spec.items() if k == "lstm"]
    out: dict[str, Tensor] = {}
    for names, draw in ((normal, torch.randn), (uniform, torch.rand)):
        sizes = [math.prod(s) for _, s in names]
        flat = draw(sum(sizes), generator=gen, device=device, dtype=dtype)
        for (n, s), t in zip(names, flat.split(sizes)):
            out[n] = t.view(s)
    convs = [out[n] for n, (k, _) in spec.items() if k == "conv"]
    torch._foreach_mul_(convs, [1.0 / math.sqrt(t[0].numel()) for t in convs])
    k = 1.0 / math.sqrt(cfg["lstm_dim"])
    lstm = [out[n] for n, _ in uniform]
    torch._foreach_mul_(lstm, 2 * k)
    torch._foreach_add_(lstm, -k)
    fill = {"zero": 0.0, "bn_w": 1.0, "bn_b": 0.0, "bn_mean": 0.0, "bn_var": 1.0,
            "bn_w_residual": cfg.get("init", {}).get("residual_bn_scale", 1.0),
            "lstm_hh_bias": 0.0, "l2norm": 20.0, "score_bias": 0.0}
    for n, (kind, s) in spec.items():
        if kind == "bn_count":
            out[n] = torch.zeros((), dtype=torch.int64, device=device)
        elif kind in fill:
            out[n] = torch.full(s, fill[kind], dtype=dtype, device=device)
        if kind == "score_bias":
            out[n][0::5] = FOCAL_PRIOR
    return {n: out[n] for n in spec}
