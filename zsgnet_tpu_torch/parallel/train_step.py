"""Train and evaluation steps — port of ``zsgnet_tpu/parallel/train_step.py``
on one device, or on one rank of a data mesh (``parallel.mesh``).

``make_compute_loss`` is the loss-variant dispatch both steps share: the
focal, multi-positive, non-softmax loss goes through the fused match +
loss (kernels K1 and K2 on CUDA, their plain versions on the CPU); every
other variant goes through the eager ``ops.losses.zsg_loss``. The port
always runs the flat (B, A) layout, so ``cfg.use_level_path`` and
``cfg.use_pallas`` select nothing here.

``make_train_step`` runs forward, loss, backward and the optimizer update
in place on a :class:`TrainState` and matches the JAX step's arithmetic:
optax's Adam / AdamW / SGD and global-norm clipping, the learning rate
times ``lr_scale`` times the warmup/decay schedule, exact full-batch
gradients under ``grad_accum``, and the EMA of the parameters. It returns
the loss dict as device tensors and never waits on the device.

Grouped multi-query batches (``cfg.queries_per_img`` Q > 1: ``qvec``
(B, Q, T), ``annot`` (B, Q, 4), ``pair_valid`` (B, Q)) give B·Q pairs,
pair-major; both steps flatten the annotations the same way and weight each
pair's loss by ``pair_valid`` (times ``valid`` in evaluation), so a
wrap-repeated pair counts zero times.

Under a :class:`~zsgnet_tpu_torch.parallel.mesh.DataMesh` (``mesh=``) each
rank runs the step on its slice of the global batch, as the JAX step does
under ``shard_map``: the losses are normalized by the global positive count
(summed between the loss sums and the division), so each rank's loss and
gradients are partials of the global batch's; after the backward the
gradients and the loss dict are summed over the ranks (``num_pos`` becomes
the global count), and clipping and the optimizer act on the sums.
BatchNorm moments are synchronized in the model (``cfg.bn_sync_axis``), so
the running statistics stay equal on every rank. The gradients go through
one bucketed ``all_reduce`` after the backward, not through
``DistributedDataParallel``: DDP averages where this step must sum, and
its buffer broadcast and bucket hooks would only repeat what the
synchronized BatchNorm and the explicit sum already give. The evaluation
step sums its loss over the ranks. Without a mesh no collective is issued.

Under a mesh with ``spatial`` S > 1 (``cfg.mesh_spatial``) the step runs the
JAX halo step: each rank takes the rows of its spatial member from its data
index's slice of the batch, the model exchanges halos and reshards
(``parallel.halo``), and ``annot``, ``pair_valid`` and ``valid`` are sliced
to the member's batch block after the reshard. From there the step is the
data-parallel one over every rank: the loss (K1 and K2 on the card) on the
rank's block, normalized by the count over the world, gradients and losses
summed over the world, BatchNorm moments over the world. SSD-VGG (the JAX
``gspmd`` mode) splits its VGG tower the same way (``models/ssd_vgg.py``).

A per-member batch (or, under ``grad_accum=k``, micro-batch) that S does
not divide is gathered, as the JAX GSPMD steps take any per-data-shard
batch: every member runs the rest of the model, the head and the loss on
the whole batch, and its copy of the loss weighs 1/S (``sample_weight``),
so the sums over the world (the positive count, the loss partials, the
gradients after the gather) count each pair once; the gather's backward, a
reduce-scatter, gives the convolutions before it their exact gradients.
Retina keeps the JAX halo step's refusal of such a batch in training; its
evaluation gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.ops import anchors as anchor_ops
from zsgnet_tpu_torch.ops import losses
from zsgnet_tpu_torch.ops.cuda.fused_loss import pack_anchors, zsg_loss_fused
from zsgnet_tpu_torch.parallel.halo import group_spatial, reshard_batch_error, spatial_train_mode
from zsgnet_tpu_torch.parallel.mesh import DataMesh, all_reduce_sum, all_reduce_sum_
from zsgnet_tpu_torch.train.evaluator import eval_batch
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor


def check_supported(cfg: Config) -> None:
    """Raise for the spatial training modes the JAX step refuses, with its
    words: GSPMD training of retina, and halo training of SSD-VGG."""
    if cfg.mesh_spatial <= 1:
        return
    mode = spatial_train_mode(cfg)
    if mode == "gspmd" and cfg.mdl_to_use == "retina":
        raise NotImplementedError(
            "spatial_mode='gspmd' training is not supported for "
            "mdl_to_use='retina': jax 0.9's SPMD partitioner mis-compiles "
            "the gradient of the ResNet+FPN forward under a height-sharded "
            "image (loss shifts ~8e-3, grads 1.5-22x off; see "
            "tools/check_spatial_gspmd.py). Use spatial_mode='auto'/'halo' "
            "(manual shard_map halo exchanges, parallel/halo.py), ssd_vgg, "
            "or spatial EVAL/serving which is unaffected."
        )
    if mode == "halo" and cfg.mdl_to_use != "retina":
        raise NotImplementedError(
            "spatial_mode='halo' is implemented for retina only; ssd_vgg "
            "trains exactly under spatial_mode='gspmd'/'auto'"
        )


def make_compute_loss(
    cfg: Config, anchors_cthw: np.ndarray, device: str | torch.device = "cuda", group=None,
) -> Callable[..., dict[str, Tensor]]:
    """→ ``compute_loss(out, annot, sample_weight=None) -> loss dict``.
    ``sample_weight`` (B,) scales every loss term and the positive count.
    With ``group`` the values are this rank's partials of the loss over
    every rank's batch (the JAX ``axis``)."""
    dev = resolve_device(device)
    anchors = torch.as_tensor(anchors_cthw, dtype=torch.float32).to(dev)
    use_fused = cfg.use_focal and cfg.use_multi and not cfg.use_softmax
    packed = pack_anchors(anchors, dev) if use_fused else None

    def compute_loss(out: dict, annot: Tensor, sample_weight: Tensor | None = None):
        if use_fused:
            return zsg_loss_fused(
                out["att_out"], out["bbx_out"], packed, annot,
                lamb_reg=cfg.lamb_reg, match_thr=cfg.matching_threshold,
                neg_thr=cfg.neg_threshold, alpha=cfg.focal_alpha,
                gamma=cfg.focal_gamma, sample_weight=sample_weight, group=group,
            )
        labels, reg_t = anchor_ops.match_and_encode(
            anchors, annot, cfg.matching_threshold, cfg.neg_threshold, use_multi=cfg.use_multi
        )
        return losses.zsg_loss(
            out["att_out"], out["bbx_out"], labels, reg_t,
            lamb_reg=cfg.lamb_reg, alpha=cfg.focal_alpha, gamma=cfg.focal_gamma,
            use_focal=cfg.use_focal, use_softmax=cfg.use_softmax,
            sample_weight=sample_weight, group=group,
        )

    return compute_loss


# The batch keys that go to the device (``qlens`` stays on the host).
DEVICE_KEYS = ("img", "qvec", "annot", "valid", "pair_valid")


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, Tensor]:
    """The model and loss inputs of a host batch (``DEVICE_KEYS`` and
    ``qlens``), as tensors on ``device`` (through pinned memory, without
    waiting, on CUDA). ``qlens`` stays on the CPU, where
    ``pack_padded_sequence`` reads it."""
    keys = [k for k in DEVICE_KEYS if k in batch]
    if device.type == "cuda":
        out = {k: torch.as_tensor(batch[k]).pin_memory().to(device, non_blocking=True) for k in keys}
    else:
        out = {k: torch.as_tensor(batch[k]).to(device) for k in keys}
    out["qlens"] = torch.as_tensor(batch["qlens"])
    return out


def train_batch_keys(cfg: Config) -> tuple[str, ...]:
    """The batch keys the train step consumes: grouped batches carry
    ``pair_valid`` too."""
    keys = ("img", "qvec", "qlens", "annot")
    return keys + ("pair_valid",) if cfg.queries_per_img > 1 else keys


def pairs_and_weights(b: dict[str, Tensor], valid: Tensor | None = None) -> tuple[Tensor, Tensor | None]:
    """(annot (N, 4), per-pair loss weights (N,) or None) of a device batch:
    a grouped batch's (B, Q, 4) annotations flattened pair-major and weighted
    by ``pair_valid`` times ``valid`` (B,) when given."""
    annot = b["annot"].float()
    w = None if valid is None else valid.float()
    if annot.dim() == 3:
        annot = annot.reshape(-1, 4)
        pv = b["pair_valid"].float()
        w = (pv if w is None else w[:, None] * pv).reshape(-1)
    return annot, w


def member_block(sp, b: dict[str, Tensor]) -> dict[str, Tensor]:
    """The spatial member's batch block of the per-sample keys other than
    the image and the queries (which the model takes whole): the block its
    model outputs carry after the reshard (the whole batch where it
    gathered)."""
    return {k: v if k in ("img", "qvec", "qlens") else sp.slice_batch(v) for k, v in b.items()}


def member_pairs(sp, b: dict[str, Tensor], weigh_valid: bool = False) -> tuple[Tensor, Tensor | None]:
    """:func:`pairs_and_weights` of the member's block (:func:`member_block`),
    times its ``valid`` with ``weigh_valid``. Where the group gathered the
    batch every member carries all of it, so each copy's weights are 1/S:
    the sums over the group count a pair once."""
    blk = member_block(sp, b)
    annot, w = pairs_and_weights(blk, blk.get("valid") if weigh_valid else None)
    if sp.gathers(b["img"].shape[0]):
        w = (torch.ones(annot.shape[0], device=annot.device) if w is None else w) / sp.size
    return annot, w


@dataclasses.dataclass
class TrainState:
    """What a train step updates. ``step`` (optimizer steps taken) and
    ``lr_scale`` (the plateau / ``fit(lr=)`` multiplier) live on the host;
    ``ema`` holds the EMA of every parameter by name, or None when
    ``cfg.ema_decay`` is 0. BatchNorm statistics live in the model."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    lr_scale: float = 1.0
    ema: dict[str, Tensor] | None = None


def make_optimizer(cfg: Config, params) -> torch.optim.Optimizer:
    """optax's optimizers of the JAX package: Adam (β 0.9/0.999, ε 1e-8),
    AdamW when ``weight_decay > 0`` (optax's decoupled decay is torch's
    p·(1 − lr·wd)), or SGD with momentum 0.9. Gradient clipping is applied
    by the step (:func:`clip_by_global_norm_`)."""
    if cfg.opt_to_use == "adam":
        if cfg.weight_decay > 0:
            return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.opt_to_use == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)
    raise ValueError(f"unknown opt_to_use: {cfg.opt_to_use}")


def clip_by_global_norm_(grads: list[Tensor], max_norm: float) -> Tensor:
    """optax's ``clip_by_global_norm`` in place, on the device: every
    gradient times max_norm/‖g‖ when the global norm ‖g‖ is not below
    max_norm (no epsilon, unlike ``clip_grad_norm_``). Returns ‖g‖."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm))
    return norm


def lr_schedule_scale(cfg: Config, step: int) -> float:
    """The JAX step's multiplicative LR factor at optimizer ``step``, in its
    float32 arithmetic: linear warmup over ``cfg.warmup_steps`` (the first
    update at lr/w), then a ``cosine`` or ``linear`` decay to
    ``lr_min_frac`` over ``cfg.lr_decay_steps`` total steps, held at the
    floor past the horizon."""
    f32 = np.float32
    s = f32(step)
    scale = f32(1.0)
    if cfg.warmup_steps > 0:
        scale = np.minimum(f32(1.0), (s + f32(1.0)) / f32(cfg.warmup_steps))
    if cfg.lr_schedule == "const":
        return float(scale)
    if cfg.lr_decay_steps <= 0:
        raise ValueError(
            f"lr_schedule={cfg.lr_schedule!r} needs lr_decay_steps > 0 "
            "(the Learner fills in epochs x batches; direct make_train_step "
            "callers must set it)"
        )
    horizon = f32(max(cfg.lr_decay_steps - cfg.warmup_steps, 1))
    prog = np.clip((s - f32(cfg.warmup_steps)) / horizon, f32(0.0), f32(1.0))
    if cfg.lr_schedule == "cosine":
        decay = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * prog))
    elif cfg.lr_schedule == "linear":
        decay = f32(1.0) - prog
    else:
        raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule}")
    floor = f32(cfg.lr_min_frac)
    return float(scale * (floor + (f32(1.0) - floor) * decay))


def create_train_state(cfg: Config, model: torch.nn.Module) -> TrainState:
    """The optimizer over the model's trainable parameters and, when
    ``cfg.ema_decay > 0``, an EMA that starts at copies of them."""
    ema = (
        {n: p.detach().clone() for n, p in model.named_parameters()}
        if cfg.ema_decay > 0 else None
    )
    params = [p for p in model.parameters() if p.requires_grad]
    return TrainState(model=model, optimizer=make_optimizer(cfg, params), ema=ema)


def _sum_losses(ls: dict[str, Tensor], group) -> dict[str, Tensor]:
    """The loss dict summed over the group's ranks, in one collective."""
    keys = list(ls)
    summed = all_reduce_sum(torch.stack([ls[k].detach().float() for k in keys]), group)
    return dict(zip(keys, summed.unbind()))


def make_train_step(
    cfg: Config, anchors_cthw: np.ndarray, device: str | torch.device = "cuda",
    mesh: DataMesh | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict[str, Tensor]]]:
    """→ ``step(state, batch) -> (state, loss dict)``; ``state`` is updated
    in place. ``batch`` is a host batch (numpy) with at least
    :func:`train_batch_keys`: under ``mesh``, this rank's slice of the
    global batch (its data index's, under a spatial mesh), and the returned
    losses are the global batch's. ``step.spatial`` is the step's spatial
    context (None without a spatial mesh); its ``landed`` says where the
    reshards landed."""
    dev = resolve_device(device)
    check_supported(cfg)
    group = mesh.group if mesh is not None else None
    sp = group_spatial(mesh)
    compute_loss = make_compute_loss(cfg, anchors_cthw, dev, group)
    k = int(cfg.grad_accum)
    scheduled = cfg.lr_schedule != "const" or cfg.warmup_steps > 0
    if scheduled:
        lr_schedule_scale(cfg, 0)  # a missing decay horizon raises here

    def forward_loss(model: torch.nn.Module, b: dict[str, Tensor]) -> dict[str, Tensor]:
        if sp is None:
            out = model(b["img"], b["qvec"], b["qlens"])
            annot, w = pairs_and_weights(b)
        else:  # the member's rows in; its batch block of everything out
            out = model(b["img"], b["qvec"], b["qlens"], spatial=sp)
            annot, w = member_pairs(sp, b)
        return compute_loss(out, annot, sample_weight=w)

    def clamped_global_pos(num_pos_local: Tensor) -> Tensor:
        n = all_reduce_sum(num_pos_local, group) if group is not None else num_pos_local.detach()
        return n.clamp(min=1.0)

    def grads_accumulated(model: torch.nn.Module, b: dict[str, Tensor]) -> dict[str, Tensor]:
        """Micro-batched backward with exact full-batch gradients. Every loss
        is normalized by the clamped positive count, a function of the
        annotations alone: each micro-batch back-propagates its loss times
        its clamped count, and the sums are divided by the clamped total
        count (a positive-free micro-batch adds its negative-anchor loss
        undivided, as in the full batch). Under a mesh both counts are
        global (JAX ``_clamped_global_pos``), and micro-batch i is every
        rank's i-th local micro-batch. BatchNorm moments are per
        micro-batch; running statistics chain through them."""
        bsz = b["img"].shape[0]
        if bsz % k:
            raise ValueError(f"grad_accum={k} does not divide the batch {bsz}")
        m = bsz // k
        sums: dict[str, Tensor] = {}
        for i in range(k):
            ls = forward_loss(model, {key: v[i * m : (i + 1) * m] for key, v in b.items()})
            w = clamped_global_pos(ls["num_pos"])
            (ls["total"] * w).backward()
            for key, v in ls.items():
                v = v.detach() if key == "num_pos" else v.detach() * w
                sums[key] = sums[key] + v if key in sums else v
        n_total = clamped_global_pos(sums["num_pos"])
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        torch._foreach_div_(grads, n_total)
        return {key: v if key == "num_pos" else v / n_total for key, v in sums.items()}

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict[str, Tensor]]:
        model = state.model
        model.train()
        batch = {key: batch[key] for key in train_batch_keys(cfg)}
        if sp is not None:
            bsz = batch["img"].shape[0]
            # The JAX halo step's refusal, before any exchange, on every rank.
            if cfg.mdl_to_use == "retina" and bsz % k == 0 and sp.gathers(bsz // k):
                raise reshard_batch_error(bsz // k, sp.size)
            batch["img"] = sp.rows(batch["img"])
        b = to_device(batch, dev)
        state.optimizer.zero_grad(set_to_none=True)
        if k > 1:
            ls = grads_accumulated(model, b)
        else:
            ls = forward_loss(model, b)
            ls["total"].backward()
            ls = {key: v.detach() for key, v in ls.items()}
        if group is not None:
            # Each rank's gradients and losses are partials of the global
            # batch's: their sums are the global values exactly.
            all_reduce_sum_([p.grad for p in model.parameters() if p.grad is not None], group)
            ls = _sum_losses(ls, group)
        if cfg.grad_clip > 0:
            clip_by_global_norm_(
                [p.grad for p in model.parameters() if p.grad is not None], cfg.grad_clip
            )
        lr = cfg.lr * state.lr_scale
        if scheduled:
            lr *= lr_schedule_scale(cfg, state.step)
        for pg in state.optimizer.param_groups:
            pg["lr"] = lr
        state.optimizer.step()
        if state.ema is not None:
            # d = min(decay, (1+t)/(10+t)) with t the steps before this
            # update, against the updated parameters; BN statistics are not
            # averaged.
            t = float(state.step)
            d = min(cfg.ema_decay, (1.0 + t) / (10.0 + t))
            with torch.no_grad():
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [p.detach() for p in model.parameters()], alpha=1.0 - d)
        state.step += 1
        return state, ls

    step.spatial = sp
    return step


def make_eval_step(
    cfg: Config, anchors_cthw: np.ndarray, device: str | torch.device = "cuda",
    mesh: DataMesh | None = None,
) -> Callable[[torch.nn.Module, dict], dict[str, Tensor]]:
    """→ ``run(model, batch) -> per-sample metrics`` (``iou``, ``correct``,
    ``pred_box``, ``max_pos``) plus ``loss``, the batch's validation loss
    broadcast per sample. The model runs in eval mode (running BatchNorm
    statistics). A ``valid`` mask in the batch weights the loss, so
    wrap-padded tail rows count zero times; a grouped batch's metrics are
    per pair (B·Q rows), its loss weighted by ``valid`` times ``pair_valid``.
    Under ``mesh`` the metrics are this rank's rows and the loss is the
    global batch's (summed over the ranks); under a spatial mesh the rows
    are this rank's block of its data index's slice (:func:`member_block`);
    where the group gathered a batch that S does not divide, member 0 holds
    every row and the others none (``SpatialCtx.counted``)."""
    dev = resolve_device(device)
    anchors = torch.as_tensor(anchors_cthw, dtype=torch.float32).to(dev)
    group = mesh.group if mesh is not None else None
    sp = group_spatial(mesh)
    compute_loss = make_compute_loss(cfg, anchors_cthw, dev, group)

    @torch.inference_mode()
    def run(model: torch.nn.Module, batch: dict) -> dict[str, Tensor]:
        model.eval()
        if sp is not None:
            batch = dict(batch, img=sp.rows(batch["img"]))
        b = to_device(batch, dev)
        if sp is None:
            out = model(b["img"], b["qvec"], b["qlens"])
            annot, w = pairs_and_weights(b, b.get("valid"))
        else:
            out = model(b["img"], b["qvec"], b["qlens"], spatial=sp)
            annot, w = member_pairs(sp, b, weigh_valid=True)
        ev = eval_batch(out["att_out"], out["bbx_out"], anchors, annot, cfg.acc_iou_threshold)
        total = compute_loss(out, annot, sample_weight=w)["total"]
        if group is not None:
            total = all_reduce_sum(total, group)
        ev["loss"] = total.expand_as(ev["iou"])
        if sp is not None and sp.gathers(b["img"].shape[0]) and sp.index:
            ev = {key: v[:0] for key, v in ev.items()}  # member 0 answers for the gathered rows
        return ev

    return run
