"""Train and evaluation steps — port of ``zsgnet_tpu/parallel/train_step.py``
for one device, no mesh.

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

Not ported yet: data parallelism (``mesh``, sync-BN), spatial
partitioning, grouped multi-query batches (``pair_valid``) and remat.
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
from zsgnet_tpu_torch.train.evaluator import eval_batch
from zsgnet_tpu_torch.utils.backend import resolve_device

Tensor = torch.Tensor


def check_supported(cfg: Config) -> None:
    """Raise for the training options this port does not run yet, naming the
    ROADMAP queue item that ports each."""
    unported = {
        "remat_backbone": (cfg.remat_backbone, "queue 1 item 2 (remat)"),
        "queries_per_img": (cfg.queries_per_img > 1, "queue 1 item 2 (grouped multi-query)"),
        "mesh_spatial": (cfg.mesh_spatial > 1, "queue 1 item 4 (spatial partitioning)"),
    }
    for key, (is_set, item) in unported.items():
        if is_set:
            raise NotImplementedError(
                f"{key}={getattr(cfg, key)!r} is not ported yet: see ROADMAP.md {item}"
            )


def make_compute_loss(
    cfg: Config, anchors_cthw: np.ndarray, device: str | torch.device = "cuda"
) -> Callable[..., dict[str, Tensor]]:
    """→ ``compute_loss(out, annot, sample_weight=None) -> loss dict``.
    ``sample_weight`` (B,) scales every loss term and the positive count."""
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
                gamma=cfg.focal_gamma, sample_weight=sample_weight,
            )
        labels, reg_t = anchor_ops.match_and_encode(
            anchors, annot, cfg.matching_threshold, cfg.neg_threshold, use_multi=cfg.use_multi
        )
        return losses.zsg_loss(
            out["att_out"], out["bbx_out"], labels, reg_t,
            lamb_reg=cfg.lamb_reg, alpha=cfg.focal_alpha, gamma=cfg.focal_gamma,
            use_focal=cfg.use_focal, use_softmax=cfg.use_softmax,
            sample_weight=sample_weight,
        )

    return compute_loss


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, Tensor]:
    """The model and loss inputs of a host batch, as tensors on ``device``
    (through pinned memory, without waiting, on CUDA). ``qlens`` stays on
    the CPU, where ``pack_padded_sequence`` reads it."""
    keys = [k for k in ("img", "qvec", "annot", "valid") if k in batch]
    if device.type == "cuda":
        out = {k: torch.as_tensor(batch[k]).pin_memory().to(device, non_blocking=True) for k in keys}
    else:
        out = {k: torch.as_tensor(batch[k]).to(device) for k in keys}
    out["qlens"] = torch.as_tensor(batch["qlens"])
    return out


def train_batch_keys(cfg: Config) -> tuple[str, ...]:
    """The batch keys the train step consumes."""
    return ("img", "qvec", "qlens", "annot")


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


def make_train_step(
    cfg: Config, anchors_cthw: np.ndarray, device: str | torch.device = "cuda"
) -> Callable[[TrainState, dict], tuple[TrainState, dict[str, Tensor]]]:
    """→ ``step(state, batch) -> (state, loss dict)``; ``state`` is updated
    in place. ``batch`` is a host batch (numpy) with at least
    :func:`train_batch_keys`."""
    dev = resolve_device(device)
    check_supported(cfg)
    compute_loss = make_compute_loss(cfg, anchors_cthw, dev)
    k = int(cfg.grad_accum)
    scheduled = cfg.lr_schedule != "const" or cfg.warmup_steps > 0
    if scheduled:
        lr_schedule_scale(cfg, 0)  # a missing decay horizon raises here

    def forward_loss(model: torch.nn.Module, b: dict[str, Tensor]) -> dict[str, Tensor]:
        out = model(b["img"], b["qvec"], b["qlens"])
        return compute_loss(out, b["annot"].float())

    def grads_accumulated(model: torch.nn.Module, b: dict[str, Tensor]) -> dict[str, Tensor]:
        """Micro-batched backward with exact full-batch gradients. Every loss
        is normalized by the clamped positive count, a function of the
        annotations alone: each micro-batch back-propagates its loss times
        its clamped count, and the sums are divided by the clamped total
        count (a positive-free micro-batch adds its negative-anchor loss
        undivided, as in the full batch). BatchNorm moments are per
        micro-batch; running statistics chain through them."""
        bsz = b["img"].shape[0]
        if bsz % k:
            raise ValueError(f"grad_accum={k} does not divide the batch {bsz}")
        m = bsz // k
        sums: dict[str, Tensor] = {}
        for i in range(k):
            ls = forward_loss(model, {key: v[i * m : (i + 1) * m] for key, v in b.items()})
            w = ls["num_pos"].detach().clamp(min=1.0)
            (ls["total"] * w).backward()
            for key, v in ls.items():
                v = v.detach() if key == "num_pos" else v.detach() * w
                sums[key] = sums[key] + v if key in sums else v
        n_total = sums["num_pos"].clamp(min=1.0)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        torch._foreach_div_(grads, n_total)
        return {key: v if key == "num_pos" else v / n_total for key, v in sums.items()}

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict[str, Tensor]]:
        model = state.model
        model.train()
        b = to_device({key: batch[key] for key in train_batch_keys(cfg)}, dev)
        state.optimizer.zero_grad(set_to_none=True)
        if k > 1:
            ls = grads_accumulated(model, b)
        else:
            ls = forward_loss(model, b)
            ls["total"].backward()
            ls = {key: v.detach() for key, v in ls.items()}
        if cfg.grad_clip > 0:
            clip_by_global_norm_(
                [p.grad for p in model.parameters() if p.grad is not None], cfg.grad_clip
            )
        lr = cfg.lr * state.lr_scale
        if scheduled:
            lr *= lr_schedule_scale(cfg, state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
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

    return step


def make_eval_step(
    cfg: Config, anchors_cthw: np.ndarray, device: str | torch.device = "cuda"
) -> Callable[[torch.nn.Module, dict], dict[str, Tensor]]:
    """→ ``run(model, batch) -> per-sample metrics`` (``iou``, ``correct``,
    ``pred_box``, ``max_pos``) plus ``loss``, the batch's validation loss
    broadcast per sample. The model runs in eval mode (running BatchNorm
    statistics). A ``valid`` mask in the batch weights the loss, so
    wrap-padded tail rows count zero times."""
    dev = resolve_device(device)
    anchors = torch.as_tensor(anchors_cthw, dtype=torch.float32).to(dev)
    compute_loss = make_compute_loss(cfg, anchors_cthw, dev)

    @torch.inference_mode()
    def run(model: torch.nn.Module, batch: dict) -> dict[str, Tensor]:
        model.eval()
        b = to_device(batch, dev)
        out = model(b["img"], b["qvec"], b["qlens"])
        annot = b["annot"].float()
        w = b["valid"].float() if "valid" in b else None
        ev = eval_batch(out["att_out"], out["bbx_out"], anchors, annot, cfg.acc_iou_threshold)
        ls = compute_loss(out, annot, sample_weight=w)
        ev["loss"] = ls["total"].expand_as(ev["iou"])
        return ev

    return run
