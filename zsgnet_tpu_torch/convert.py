"""Checkpoint conversion into the port: JAX variables → ``state_dict``, and
a reference ``.pth`` → a port checkpoint directory.

    python -m zsgnet_tpu_torch.convert <ref.pth> <out_dir> [--vocab=vocab.json] [--key=val ...]

reads a reference (``zsgnet-pytorch``) checkpoint — a bare state dict, a
trainer dict with ``model_state_dict``/``model``/``state_dict``/``mdl``, or a
whole saved module, with or without DDP's ``module.`` — detects where its
subtrees live (``detect_layout``, printed), maps them onto the port's names,
loads what matches by name and shape over a fresh ``ZSGNet`` and writes
``step_0.pt`` and ``cfg.json`` (and ``vocab.json`` with ``--vocab=``), which
``Grounder.from_checkpoint`` and ``main --resume`` read. ``--backbone_prefix=``
and the other layout keys override what was detected; every other
``--key=val`` is a Config override.

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

import json
import re
import shutil
import sys
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from zsgnet_tpu_torch.config import Config, get_default_cfg
from zsgnet_tpu_torch.models.zsgnet import get_default_net
from zsgnet_tpu_torch.train.checkpoint import CheckpointManager, partial_load

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


# Where the port's state_dict keeps each subtree that detect_layout finds.
PORT_LAYOUT = {
    "backbone_prefix": "backbone.encoder.",
    "fpn_prefix": "backbone.fpn.",
    "lstm_prefix": "lstm.",
    "embed_key": "embedding.weight",
    "head_conv_prefixes": ("head.conv0", "head.conv1", "head.conv2", "head.conv3", "head.out"),
}


def detect_layout(sd: Mapping[str, Any]) -> dict[str, Any]:
    """Subtree prefixes from a state dict's key structure: backbone_prefix,
    fpn_prefix, lstm_prefix, embed_key, head_conv_prefixes and num_anchors
    (None or empty where not found)."""
    keys = list(sd.keys())

    def find_prefix(marker: str) -> str | None:
        for k in keys:
            i = k.find(marker)
            if i >= 0:
                return k[:i]
        return None

    backbone = find_prefix("layer1.0.conv1.weight")  # ResNet-50 body
    lstm = find_prefix("weight_ih_l0")
    embed_key = next((k for k in keys if re.search(r"emb\w*\.weight$", k)
                      and getattr(sd[k], "ndim", 0) == 2), None)
    fpn = find_prefix("latlayer1.weight")
    # The head: a group of convs whose last (out) has 5·A output channels.
    head_prefixes: tuple[str, ...] = ()
    num_anchors = None
    conv_groups: dict[str, list[str]] = {}
    for k in keys:
        m = re.match(r"(.*\.)((?:conv\d+|out|att_reg_box))\.weight$", k)
        if m and getattr(sd[k], "ndim", 0) == 4:
            conv_groups.setdefault(m.group(1), []).append(m.group(2))
    for prefix, names in conv_groups.items():
        if backbone and prefix.startswith(backbone):
            continue
        out_name = "out" if "out" in names else ("att_reg_box" if "att_reg_box" in names else None)
        convs = sorted(n for n in names if n.startswith("conv"))
        if out_name and convs:
            oc = sd[f"{prefix}{out_name}.weight"].shape[0]
            if oc % 5 == 0:
                head_prefixes = tuple(f"{prefix}{n}" for n in convs) + (f"{prefix}{out_name}",)
                num_anchors = oc // 5
                break
    return {
        "backbone_prefix": backbone,
        "fpn_prefix": fpn,
        "lstm_prefix": lstm,
        "embed_key": embed_key,
        "head_conv_prefixes": head_prefixes,
        "num_anchors": num_anchors,
    }


def unwrap_state_dict(obj: Any) -> Mapping[str, Any]:
    """A ``torch.save`` payload → a flat state dict (a trainer dict's model
    entry, a whole module's state dict, DDP's ``module.`` removed)."""
    sd = obj
    if isinstance(obj, dict) and not any(hasattr(v, "shape") for v in obj.values()):
        for key in ("model_state_dict", "model", "state_dict", "mdl"):
            if key in obj:
                sd = obj[key]
                break
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if any(k.startswith("module.") for k in sd):
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
    return sd


def to_port_names(sd: Mapping[str, Any], layout: Mapping[str, Any]) -> dict[str, Any]:
    """Rename the detected subtrees of ``sd`` onto ``PORT_LAYOUT``; keys in no
    detected subtree keep their names. The most specific prefix wins: the
    head's convs, the LSTM, the FPN, then the backbone, whose prefix may be
    empty."""
    head = tuple(layout["head_conv_prefixes"] or ())
    port_head = PORT_LAYOUT["head_conv_prefixes"]
    prefixes = [(p + ".", q + ".") for p, q in zip(head[:-1], port_head[:-1])]
    if head:
        prefixes.append((head[-1] + ".", port_head[-1] + "."))
    prefixes += [(layout[k], PORT_LAYOUT[k]) for k in ("lstm_prefix", "fpn_prefix", "backbone_prefix")
                 if layout[k] is not None]
    out: dict[str, Any] = {}
    for k, v in sd.items():
        if k == layout["embed_key"]:
            k = PORT_LAYOUT["embed_key"]
        else:
            src, dst = next(((s, d) for s, d in prefixes if k.startswith(s)), ("", ""))
            k = dst + k[len(src):]
        out[k] = v
    return out


def main(argv: list[str] | None = None) -> dict[str, Any]:
    argv = sys.argv[1:] if argv is None else argv
    pos = [a for a in argv if not a.startswith("--")]
    overrides = dict(a[2:].split("=", 1) for a in argv if a.startswith("--") and "=" in a)
    if len(pos) != 2:
        raise SystemExit(__doc__)
    pth, out_dir = Path(pos[0]), Path(pos[1])
    sd = unwrap_state_dict(torch.load(pth, map_location="cpu", weights_only=False))

    layout = detect_layout(sd)
    for k in list(layout):
        if k in overrides:
            v = overrides.pop(k)
            layout[k] = (tuple(v.split(",")) if k == "head_conv_prefixes"
                         else int(v) if k == "num_anchors" else v)
    print(f"detected layout: {json.dumps(layout, default=list)}")
    missing = [k for k, v in layout.items() if not v]
    if missing:
        print(f"WARNING: could not detect {missing}; those subtrees keep fresh init "
              "(override with --<name>=...)")

    embed = sd[layout["embed_key"]] if layout["embed_key"] else None
    vocab_size = int(overrides.pop("vocab_size", embed.shape[0] if embed is not None else 10000))
    emb_dim = int(embed.shape[1]) if embed is not None else 300
    vocab_src = overrides.pop("vocab", None)
    cfg = get_default_cfg().replace(**{"compute_dtype": "float32", "do_dist": False,
                                       "emb_dim": emb_dim, **overrides})
    fresh = get_default_net(cfg, vocab_size, device="cpu").state_dict()
    mapped = {k: torch.as_tensor(v) for k, v in to_port_names(sd, layout).items()}
    model = partial_load(fresh, mapped)
    converted = sum(1 for k in fresh if model[k] is not fresh[k])

    CheckpointManager(out_dir).save(0, {"model": model, "best_metric": -1.0})
    (out_dir / "cfg.json").write_text(cfg.replace(vocab_size=vocab_size).dumps())
    if vocab_src:
        shutil.copy(vocab_src, out_dir / "vocab.json")
    report = {
        "leaves_total": len(fresh),
        "leaves_converted": converted,
        "vocab_size": vocab_size,
        "out_dir": str(out_dir),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
