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
  interleave (the inverse of ``regroup_head_kernel``); JAX's per-level
  ``head{i}`` go to ``heads.<i>``;
* the SSD-VGG backbone's ``conv{b}_{k}``, ``conv6``, ``conv7``,
  ``l2norm/scale``, ``extra{b}_{k}`` and ``proj{i}`` go to amdegroot's names
  (``backbone.vgg.<i>``, ``backbone.L2Norm.weight``, ``backbone.extras.<i>``)
  and ``backbone.proj.<i>``;
* a ``quant`` collection (a calibrated int8 model's activation scales,
  ``act_absmax_{H}x{W}`` per conv and the heads' ``vis_absmax_{H}x{W}``)
  goes onto the same modules' scale buffers (``models/quant.py``), so an
  int8 ``Grounder`` serves the JAX calibration.

``detect_layout`` and the ``.pth`` command line find the retina layout.
A reference SSD checkpoint needs no layout: its backbone already has the
port's names below ``backbone.``, so ``partial_load`` takes it by name.
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


# The JAX SSD-VGG16's conv names for amdegroot's ``vgg`` Sequential indices.
SSD_VGG_INDICES = {
    "conv1_1": 0, "conv1_2": 2, "conv2_1": 5, "conv2_2": 7,
    "conv3_1": 10, "conv3_2": 12, "conv3_3": 14,
    "conv4_1": 17, "conv4_2": 19, "conv4_3": 21,
    "conv5_1": 24, "conv5_2": 26, "conv5_3": 28, "conv6": 31, "conv7": 33,
}


def _conv_layer(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _conv(p["kernel"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def ssd_backbone_from_jax(bp: Mapping, prefix: str = "backbone.") -> dict[str, torch.Tensor]:
    """The JAX ``SSDVGG16`` params → ``models.ssd_vgg.SSDVGG16``'s
    ``state_dict`` (amdegroot names), each key under ``prefix``."""
    sd: dict[str, torch.Tensor] = {}
    for name, i in SSD_VGG_INDICES.items():
        _conv_layer(sd, f"{prefix}vgg.{i}", bp[name])
    sd[f"{prefix}L2Norm.weight"] = _t(bp["l2norm"]["scale"])
    for i in range(8):
        _conv_layer(sd, f"{prefix}extras.{i}", bp[f"extra{i // 2 + 1}_{i % 2 + 1}"])
    for i in range(6):
        if f"proj{i}" in bp:
            _conv_layer(sd, f"{prefix}proj.{i}", bp[f"proj{i}"])
    return sd


def _resnet_fpn(sd: dict, params: Mapping, stats: Mapping) -> None:
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
        _conv_layer(sd, f"backbone.fpn.{theirs}", params["fpn"][ours])


def _head(sd: dict, prefix: str, head: Mapping, num_anchors: int) -> None:
    sd[f"{prefix}.conv0.weight"] = _conv(head["conv0_kernel"])
    sd[f"{prefix}.conv0.bias"] = _t(head["conv0_bias"])
    for i in (1, 2, 3):
        _conv_layer(sd, f"{prefix}.conv{i}", head[f"conv{i}"])
    k_out, b_out = ungroup_head_channels(head["out"]["kernel"], head["out"]["bias"], num_anchors)
    sd[f"{prefix}.out.weight"] = _conv(k_out)
    sd[f"{prefix}.out.bias"] = _t(b_out)


def _scales(sd: dict, prefix: str, tree: Mapping) -> None:
    for name, v in tree.items():
        if "_absmax_" in name:
            sd[f"{prefix}.{name}"] = _t(v)


def quant_state_from_jax(quant: Mapping[str, Any], cfg: Config) -> dict[str, torch.Tensor]:
    """The JAX ``quant`` collection → the port's scale buffers."""
    sd: dict[str, torch.Tensor] = {}
    bb = quant.get("backbone", {})
    if cfg.mdl_to_use == "ssd_vgg":
        for name, i in SSD_VGG_INDICES.items():
            _scales(sd, f"backbone.vgg.{i}", bb.get(name, {}))
        for i in range(8):
            _scales(sd, f"backbone.extras.{i}", bb.get(f"extra{i // 2 + 1}_{i % 2 + 1}", {}))
    else:
        _scales(sd, "backbone.encoder.conv1", bb.get("conv1", {}))
        for j_name, block in bb.items():
            m = re.fullmatch(r"layer(\d)_(\d+)", j_name)
            if m is None:
                continue
            for conv, tree in block.items():
                port = "downsample.0" if conv == "downsample_conv" else conv
                _scales(sd, f"backbone.encoder.layer{m[1]}.{m[2]}.{port}", tree)
        for ours, theirs in FPN_NAME_MAP.items():
            _scales(sd, f"backbone.fpn.{theirs}", quant.get("fpn", {}).get(ours, {}))
    heads = {"head": "head"} if "head" in quant else {
        k: f"heads.{k[4:]}" for k in quant if re.fullmatch(r"head\d+", k)}
    for j_name, port in heads.items():
        _scales(sd, port, quant[j_name])
        for conv in ("conv1", "conv2", "conv3", "out"):
            _scales(sd, f"{port}.{conv}", quant[j_name].get(conv, {}))
    return sd


def state_dict_from_jax(variables: Mapping[str, Any], cfg: Config) -> dict[str, torch.Tensor]:
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    if cfg.mdl_to_use == "ssd_vgg":
        sd.update(ssd_backbone_from_jax(params["backbone"]))
    else:
        _resnet_fpn(sd, params, stats)

    qe = params["query_enc"]
    sd["embedding.weight"] = _t(qe["embed"]["embedding"])
    for direction, sfx in (("fwd", "l0"), ("bwd", "l0_reverse")):
        d = qe[direction]
        sd[f"lstm.weight_ih_{sfx}"] = _t(np.asarray(d["w_ih"]).T)
        sd[f"lstm.weight_hh_{sfx}"] = _t(np.asarray(d["w_hh"]).T)
        sd[f"lstm.bias_ih_{sfx}"] = _t(d["bias"])
        sd[f"lstm.bias_hh_{sfx}"] = torch.zeros_like(_t(d["bias"]))

    if "head" in params:
        _head(sd, "head", params["head"], cfg.num_anchors)
    else:
        i = 0
        while f"head{i}" in params:
            _head(sd, f"heads.{i}", params[f"head{i}"], cfg.num_anchors)
            i += 1
    sd.update(quant_state_from_jax(variables.get("quant", {}), cfg))
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
