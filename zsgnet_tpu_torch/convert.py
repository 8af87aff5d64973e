"""JAX variables → the port's ``state_dict``.

``state_dict_from_jax`` takes the JAX ``ZSGNet``'s ``{"params",
"batch_stats"}`` tree (leaves as numpy arrays) and returns a ``state_dict``
for ``models.zsgnet.ZSGNet``. It is the inverse of
``zsgnet_tpu/convert/torch_import.py::convert_zsgnet_checkpoint``:

* conv kernels (kH, kW, I, O) → (O, I, kH, kW);
* BatchNorm scale/bias + mean/var → weight/bias + running_mean/var;
* LSTM ``w_ih`` (E, 4H) / ``w_hh`` (H, 4H) → (4H, E) / (4H, H), same gate
  order (i, f, g, o); JAX's one summed bias goes to ``bias_ih`` and zeros to
  ``bias_hh``;
* the head's output conv goes from JAX's component-grouped channels
  [score·A | dy·A | dx·A | dh·A | dw·A] back to the reference's per-anchor
  interleave (the inverse of ``regroup_head_kernel``).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from zsgnet_tpu_torch.config import Config

# The port's FPN module names (reference lineage) for the JAX FPN's names.
FPN_NAME_MAP = {
    "lat5": "latlayer1",
    "lat4": "latlayer2",
    "lat3": "latlayer3",
    "smooth5": "toplayer0",
    "smooth4": "toplayer1",
    "smooth3": "toplayer2",
    "p6": "conv6",
    "p7": "conv7",
}


def _t(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel: Any) -> torch.Tensor:
    """(kH, kW, I, O) → (O, I, kH, kW)."""
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))


def _bn(sd: dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def ungroup_head_channels(kernel: np.ndarray, bias: np.ndarray, num_anchors: int):
    """Component-grouped output channels → per-anchor interleaved: channel
    a·5 + k of the result is channel k·A + a of the input (last axis)."""
    a = num_anchors
    perm = np.array([k * a + i for i in range(a) for k in range(5)])
    return np.asarray(kernel)[..., perm], np.asarray(bias)[perm]


def state_dict_from_jax(variables: Mapping[str, Any], cfg: Config) -> dict[str, torch.Tensor]:
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}

    bp, bs = params["backbone"], stats["backbone"]
    stem = bp["conv1"]["kernel"] if "conv1" in bp else bp["conv1_kernel"]
    sd["backbone.encoder.conv1.weight"] = _conv(stem)
    _bn(sd, "backbone.encoder.bn1", bp["bn1"], bs["bn1"])
    for stage_i, n_blocks in enumerate((3, 4, 6, 3)):
        for block_i in range(n_blocks):
            j_name = f"layer{stage_i + 1}_{block_i}"
            t_pre = f"backbone.encoder.layer{stage_i + 1}.{block_i}"
            jp, js = bp[j_name], bs[j_name]
            for j in (1, 2, 3):
                sd[f"{t_pre}.conv{j}.weight"] = _conv(jp[f"conv{j}"]["kernel"])
                _bn(sd, f"{t_pre}.bn{j}", jp[f"bn{j}"], js[f"bn{j}"])
            if "downsample_conv" in jp:
                sd[f"{t_pre}.downsample.0.weight"] = _conv(jp["downsample_conv"]["kernel"])
                _bn(sd, f"{t_pre}.downsample.1", jp["downsample_bn"], js["downsample_bn"])

    for ours, theirs in FPN_NAME_MAP.items():
        sd[f"backbone.fpn.{theirs}.weight"] = _conv(params["fpn"][ours]["kernel"])
        sd[f"backbone.fpn.{theirs}.bias"] = _t(params["fpn"][ours]["bias"])

    qe = params["query_enc"]
    sd["embedding.weight"] = _t(qe["embed"]["embedding"])
    for direction, sfx in (("fwd", "l0"), ("bwd", "l0_reverse")):
        d = qe[direction]
        sd[f"lstm.weight_ih_{sfx}"] = _t(np.asarray(d["w_ih"]).T)
        sd[f"lstm.weight_hh_{sfx}"] = _t(np.asarray(d["w_hh"]).T)
        sd[f"lstm.bias_ih_{sfx}"] = _t(d["bias"])
        sd[f"lstm.bias_hh_{sfx}"] = torch.zeros_like(_t(d["bias"]))

    head = params["head"]
    sd["head.conv0.weight"] = _conv(head["conv0_kernel"])
    sd["head.conv0.bias"] = _t(head["conv0_bias"])
    for i in (1, 2, 3):
        sd[f"head.conv{i}.weight"] = _conv(head[f"conv{i}"]["kernel"])
        sd[f"head.conv{i}.bias"] = _t(head[f"conv{i}"]["bias"])
    k_out, b_out = ungroup_head_channels(head["out"]["kernel"], head["out"]["bias"], cfg.num_anchors)
    sd["head.out.weight"] = _conv(k_out)
    sd["head.out.bias"] = _t(b_out)
    return sd
