"""The comparison that decides ``correct``: the plain reference run on the
inputs that the timed path took, and the gaps between the two sides. Each
cell's ``limits/<cell>.json`` names the numbers it compares.

Training (the first three steps of the step object that the window drives):

* ``out_diff``: the first step's box deltas against the reference's, the
  norm of their difference over the reference's;
* ``loss_gap``: the largest relative gap between the program's loss and the
  reference's over the three steps;
* ``grad_gap``: the first gradient as the program's optimizer got it
  (Adam's first moment after one step over 1 − β1), by the worst leaf: the
  gap between the two norms of a leaf over the larger of the reference's norm
  of that leaf and of the median leaf;
* ``change_gap``: the same for the parameters' change over the three steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a leaf with none moves by round-off alone under Adam).

Grounding (a sample of the answers that the window's requests got): an
anchor explains an answer where its reference logit lies within
``LOGIT_SLACK`` of the reference's best and the sigmoid of that logit
within ``SCORE_SLACK`` of the served score; a* is the explaining anchor
whose reference box lies nearest the served box (the best reference score
among equal boxes). So the score channel and the anchor that the decode
picks are held with the box:

* ``box_ratio``: ``box_rel``, the served boxes' distance from the
  reference's boxes at a* over the reference boxes' distance from their
  anchors, summed over the sample, over ``box_rel_bf16``, the same for the
  reference's own boxes under bfloat16 convolutions (``bf16_conv``): how
  far the program's answers lie from the reference in units of what the
  configuration's own rounding moves them, for these weights and inputs,
  which move the boxes' sensitivity to rounding 3x from seed to seed. An
  answer that no anchor explains counts the whole of its reference box's
  move from the reference's best anchor, or its distance from that box
  where it is larger;
* printed beside it, not compared: ``box_rel``, ``box_rel_bf16``, ``anchor_gap`` (how far a*'s reference
  logit lies below the reference's best), ``score_gap`` (the served score
  against the sigmoid of a*'s reference logit), ``box_gap`` (the served box
  against the reference's at a*), each as the worst request's and the mean;
  ``flip_share`` (a* is not the reference's best) and ``missed_share`` (no
  anchor explains the answer).
"""

from __future__ import annotations

import statistics

import torch
import torch.nn.functional as F

from benchmark.reference import loss as ref_loss
from benchmark.reference import model as ref_model

Tensor = torch.Tensor

BETA1 = 0.9
MOVED = 1e-3  # a leaf whose reference gradient norm is under this share of the median leaf's is not counted
# Rounding allowed a served answer before it counts as another anchor's: the
# bf16 program's worst readings over 48 seeds were a logit gap of 0.039 and a
# score gap of 0.0018 (PERF.md gives them).
LOGIT_SLACK = 0.1
SCORE_SLACK = 0.002


def _round(t: Tensor, fmt: torch.dtype) -> Tensor:
    """``t`` rounded to a float8 format with one scale for the tensor (its
    largest magnitude at the format's largest finite value)."""
    top = torch.finfo(fmt).max
    scale = t.abs().amax().float().clamp(min=1e-30) / top
    return ((t.float() / scale).to(fmt).float() * scale).to(t.dtype)


class _Fp8Conv(torch.autograd.Function):
    """A convolution whose operands are float8: e4m3 input and weight, e5m2
    output gradient, each scaled per tensor, products summed in float32;
    its output, bias and input gradient rounded to bfloat16 as the
    program's autocast rounds them."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        xq, wq = _round(x, torch.float8_e4m3fn), _round(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.geom, ctx.bias = (stride, padding, dilation), b is not None
        y = F.conv2d(xq, wq, None, stride, padding, dilation)
        if b is not None:
            y = y + b.bfloat16().float()[None, :, None, None]
        return y.bfloat16().float()

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        g = _round(gy, torch.float8_e5m2)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, g, *ctx.geom).bfloat16().float()
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, g, *ctx.geom)
        gb = gy.sum(dim=(0, 2, 3)) if ctx.bias else None
        return gx, gw, gb, None, None, None


def fp8_conv(x, w, b=None, stride=1, padding=0, dilation=1) -> Tensor:
    """The control's convolution: the reference's, one precision below the
    configuration's bfloat16 (``_Fp8Conv``)."""
    return _Fp8Conv.apply(x, w, b, stride, padding, dilation)


def bf16_conv(x, w, b=None, stride=1, padding=0, dilation=1) -> Tensor:
    """A convolution in the configuration's own precision: bfloat16 operands
    and bias, float32 sums, the output rounded to bfloat16, as the program's
    autocast computes it. The grounding comparison's yardstick of rounding."""
    y = F.conv2d(x.bfloat16(), w.bfloat16(), None if b is None else b.bfloat16(), stride, padding, dilation)
    return y.float()


def leaf_gap(prog: dict[str, float], ref: dict[str, float], names: list[str]) -> tuple[float, str]:
    """The worst leaf's gap of norms over max(its reference norm, the median
    leaf's) → (gap, leaf)."""
    floor = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], floor, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def train_readings(prog: dict, ref: dict) -> dict[str, float]:
    """``prog``/``ref``: {"loss": [3 floats], "grad": {leaf: norm},
    "change": {leaf: norm}} → the three gaps."""
    names = sorted(ref["grad"])
    if sorted(prog["grad"]) != names:
        raise ValueError(f"the program's trainable leaves differ from the reference's: "
                         f"{sorted(set(prog['grad']) ^ set(names))[:6]}")
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    floor = statistics.median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= MOVED * floor]
    out = {"loss_gap": loss_gap,
           "grad_gap": leaf_gap(prog["grad"], ref["grad"], names)[0],
           "change_gap": leaf_gap(prog["change"], ref["change"], moved)[0]}
    if "out_t" in prog and "out_t" in ref:
        out.update(output_difference(prog["out_t"], ref["out_t"]))
    return out


def output_difference(prog: dict[str, Tensor], ref: dict[str, Tensor]) -> dict[str, float]:
    """The first step's box deltas against the reference's: the norm of
    their difference over the reference's (``out_diff``). Rows the program
    did not produce count as zeros."""
    r = ref["bbx"].double()
    p = torch.zeros_like(r)
    n = min(prog["bbx"].shape[0], r.shape[0])
    p[:n] = prog["bbx"][:n].to(r.device, torch.float64)
    return {"out_diff": float((p - r).norm() / r.norm().clamp(min=1e-300))}


def reference_train(cfg: dict, state: dict[str, Tensor], batches: list[dict], steps: int = 3,
                    conv=None, group=None) -> dict:
    """The reference's first ``steps`` Adam steps from ``state`` on device
    ``batches`` (img, qvec, qlens, annot) → {"loss", "grad", "change"} as
    :func:`train_readings` takes them. Runs in float32 with TF32 off, its
    convolutions through ``conv`` where given. With ``group`` the batches
    are this rank's rows of a batch spread over the group's ranks: the
    BatchNorm moments and the positive count are the whole batch's, and the
    losses and gradients are summed over the ranks."""
    spec = ref_model.param_shapes(cfg, state["embedding.weight"].shape[0])
    names = ref_model.trainable(spec)
    dev = state["embedding.weight"].device
    anchors = ref_model.anchors(cfg, torch.float32).to(dev)
    params = {n: t.detach().clone() for n, t in state.items()}
    opt = ref_loss.Adam(cfg["lr"])
    out = {"loss": []}
    with tf32_off():
        for i, b in enumerate(batches[:steps]):
            for n in names:
                params[n].requires_grad_(True)
            att, bbx = ref_model.forward(cfg, params, b["img"], b["qvec"], b["qlens"], train=True, conv=conv,
                                         group=group)
            total = ref_loss.loss(cfg, att, bbx, anchors, b["annot"].float(), group)
            grads = torch.autograd.grad(total, [params[n] for n in names])
            if group is not None:
                total = total.detach().clone()
                for t in (total, *grads):
                    torch.distributed.all_reduce(t, group=group)
            if i == 0:
                out["out_t"] = {"bbx": bbx.detach()}
            del att, bbx
            out["loss"].append(float(total.detach()))
            for n in names:
                params[n] = params[n].detach()
            if i == 0:
                out["grad"] = dict(zip(names, norms(grads)))
            opt.step(params, dict(zip(names, grads)))
            del grads, total
    out["change"] = dict(zip(names, norms([params[n] - state[n] for n in names])))
    return out


def norms(tensors) -> list[float]:
    """Each tensor's 2-norm in float64, read back in one transfer."""
    return torch.stack([t.detach().double().norm() for t in tensors]).tolist()


class tf32_off:
    """float32 matrix products and convolutions in float32 inside."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


@torch.no_grad()
def reference_ground(cfg: dict, state: dict[str, Tensor], img: Tensor, qvec: Tensor, qlens: Tensor,
                     block: int = 32, conv=None) -> tuple[Tensor, Tensor]:
    """Reference score logits (N, A) and boxes at every anchor (N, A, 4) of
    N requests, in blocks of ``block`` rows, float32 with TF32 off, its
    convolutions through ``conv`` where given."""
    anchors = ref_model.anchors(cfg, torch.float32).to(img.device)
    atts, boxes = [], []
    with tf32_off():
        for s in range(0, img.shape[0], block):
            sl = slice(s, s + block)
            att, bbx = ref_model.forward(cfg, state, img[sl], qvec[sl], qlens[sl], conv=conv)
            atts.append(att)
            boxes.append(ref_loss.decode(anchors[None], bbx))
    return torch.cat(atts), torch.cat(boxes)


def ground_readings(att: Tensor, boxes: Tensor, served_box: Tensor, served_score: Tensor,
                    anchors: Tensor, boxes_bf16: Tensor) -> dict[str, float]:
    """Reference logits (N, A) and boxes (N, A, 4) against the served boxes
    (N, 4) and scores (N,), with the reference's boxes under bfloat16
    convolutions (N, A, 4) as the yardstick → ``box_ratio`` and the printed
    gaps (see the module's docstring)."""
    best = att.amax(dim=1, keepdim=True)
    explains = (att >= best - LOGIT_SLACK) & ((torch.sigmoid(att) - served_score[:, None]).abs() <= SCORE_SLACK)
    missed = ~explains.any(dim=1)
    explains[missed] = att[missed] >= best[missed]  # the reference's own answer, against which a miss counts
    dist = (boxes - served_box[:, None, :]).abs().amax(dim=-1)
    dist = torch.where(explains, dist, torch.full_like(dist, torch.inf))
    near = dist <= dist.amin(dim=1, keepdim=True) + 1e-6
    pick = torch.where(near, att, torch.full_like(att, -torch.inf)).argmax(dim=1)
    rows = torch.arange(att.shape[0], device=att.device)
    chosen = att[rows, pick]
    gaps = {"anchor_gap": best[:, 0] - chosen,
            "score_gap": (served_score - torch.sigmoid(chosen)).abs(),
            "box_gap": dist[rows, pick]}
    out = {k: float(v.max()) for k, v in gaps.items()}
    out.update({f"{k}_mean": float(v.double().mean()) for k, v in gaps.items()})
    out["flip_share"] = float((gaps["anchor_gap"] > 0).double().mean())
    out["missed_share"] = float(missed.double().mean())
    anchor_box = ref_loss.cthw_to_tlbr(anchors[pick]).clamp(-1, 1)
    moved = (boxes[rows, pick] - anchor_box).abs().amax(dim=-1)
    err = torch.where(missed, torch.maximum(gaps["box_gap"], moved), gaps["box_gap"])
    out["box_rel"] = float(err.double().sum() / moved.double().sum().clamp(min=1e-30))
    err16 = (boxes_bf16[rows, pick] - boxes[rows, pick]).abs().amax(dim=-1)
    out["box_rel_bf16"] = float(err16.double().sum() / moved.double().sum().clamp(min=1e-30))
    out["box_ratio"] = out["box_rel"] / max(out["box_rel_bf16"], 1e-30)
    return out


def verdict(readings: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """Every reading at or under its limit (a reading that is not a finite
    number fails) → (correct, {name: {"value", "limit"}})."""
    missing = set(limits) - set(readings)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    table = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in table.values())
    return ok, table
