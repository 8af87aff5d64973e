"""Fused anchor match + focal + smooth-L1 loss — kernel K1 and its plain version.

Port of ``zsgnet_tpu/ops/pallas/fused_loss.py`` (forward only; evaluation
needs no gradient). ``fused_match_loss`` returns the three sums
(cls_sum, box_sum, num_pos) that ``zsg_loss_fused`` normalizes:

* on CUDA tensors it launches the hand-written kernel in
  ``csrc/fused_loss.cu`` (built at first use, ``ops/cuda/build.py``) or
  raises — it never falls back;
* on CPU tensors it runs ``fused_match_loss_reference``, the same function
  in eager PyTorch.

Both compute the prologue too, each row's first-index argmax-IoU anchor,
which the JAX package runs as XLA outside its Pallas kernel.
``fused_match_loss.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from zsgnet_tpu_torch.ops import boxes as box_ops
from zsgnet_tpu_torch.ops.losses import sigmoid_focal_loss, smooth_l1

Tensor = torch.Tensor

BETA = 1.0 / 9.0  # smooth-L1 beta of the RetinaNet recipe, fixed as in the JAX kernel


def pack_anchors(anchors_cthw: np.ndarray | Tensor, device: str | torch.device) -> tuple[Tensor, Tensor]:
    """(A, 4) cthw anchors → contiguous float32 (tlbr, cthw) on ``device``,
    the two anchor inputs of :func:`fused_match_loss`."""
    cthw = torch.as_tensor(anchors_cthw, dtype=torch.float32).to(device).contiguous()
    return box_ops.cthw2tlbr(cthw).contiguous(), cthw


def fused_match_loss_reference(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor,
    gt: Tensor, w: Tensor, match_thr: float = 0.5, neg_thr: float = 0.4,
    alpha: float = 0.25, gamma: float = 2.0,
) -> Tensor:
    """Plain PyTorch version of the kernel: the same labels, losses and
    weights, as dense tensors. Returns (3,) float32 [cls_sum, box_sum, num_pos]."""
    iou = box_ops.iou_pairwise(gt[:, None, :], anchors_tlbr)[:, 0, :]
    best = iou.argmax(dim=-1, keepdim=True)  # the first of tied maxima
    is_best = torch.zeros_like(iou, dtype=torch.bool).scatter(-1, best, True)
    pos_b = (iou >= match_thr) | is_best
    pos = pos_b.float()
    valid = (pos_b | (iou < neg_thr)).float()
    w = w.float()[:, None]
    cls_sum = (sigmoid_focal_loss(att, pos, alpha, gamma) * valid * w).sum()
    targets = box_ops.bbox_to_reg_params(anchors_cthw[None], gt[:, None, :])
    pos_w = pos * w
    box_sum = (smooth_l1(bbx, targets, BETA) * pos_w[..., None]).sum()
    return torch.stack([cls_sum, box_sum, pos_w.sum()])


def _lib() -> ctypes.CDLL:
    from zsgnet_tpu_torch.ops.cuda import build

    lib = build.load("fused_loss")
    if not getattr(lib, "_zsg_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.zsg_match_loss_fwd.argtypes = [ptr] * 10 + [i32, i32] + [f32] * 5 + [ptr]
        lib.zsg_match_loss_fwd.restype = i32
        lib.zsg_match_loss_chunk.argtypes = []
        lib.zsg_match_loss_chunk.restype = i32
        lib._zsg_typed = True
    return lib


def _check(
    name: str, t: Tensor, shape: tuple[int, ...], dtype: torch.dtype, device: torch.device,
    vec4: bool = False,
) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if vec4 and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned for the kernel's float4 loads")


def _launch(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor,
    gt: Tensor, w: Tensor, match_thr: float, neg_thr: float, alpha: float, gamma: float,
) -> Tensor:
    """Check the CUDA tensors and launch the kernel on the current stream."""
    if att.dim() != 2:
        raise ValueError(f"att must be (B, A), got shape {tuple(att.shape)}")
    b, a = att.shape
    dev = att.device
    f32 = torch.float32
    _check("att", att, (b, a), f32, dev)
    _check("bbx", bbx, (b, a, 4), f32, dev, vec4=True)
    _check("anchors_tlbr", anchors_tlbr, (a, 4), f32, dev, vec4=True)
    _check("anchors_cthw", anchors_cthw, (a, 4), f32, dev, vec4=True)
    _check("gt", gt, (b, 4), f32, dev, vec4=True)
    _check("w", w, (b,), f32, dev)
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} is outside the kernel's grid limit (1..65535)")
    lib = _lib()
    n_chunks = -(-a // lib.zsg_match_loss_chunk())
    cand_v = torch.empty((b * n_chunks,), dtype=f32, device=dev)
    cand_i = torch.empty((b * n_chunks,), dtype=torch.int32, device=dev)
    partials = torch.empty((b * n_chunks * 3,), dtype=f32, device=dev)
    out = torch.empty((3,), dtype=f32, device=dev)
    with torch.cuda.device(dev):  # the runtime launches on the current device
        err = lib.zsg_match_loss_fwd(
            att.data_ptr(), bbx.data_ptr(), anchors_tlbr.data_ptr(), anchors_cthw.data_ptr(),
            gt.data_ptr(), w.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(),
            partials.data_ptr(), out.data_ptr(), b, a, match_thr, neg_thr, alpha, gamma, BETA,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_loss kernel launch failed with CUDA error {err}")
    return out


def fused_match_loss(
    att: Tensor, bbx: Tensor, anchors_tlbr: Tensor, anchors_cthw: Tensor,
    gt: Tensor, w: Tensor, match_thr: float = 0.5, neg_thr: float = 0.4,
    alpha: float = 0.25, gamma: float = 2.0,
) -> Tensor:
    """(3,) float32 [cls_sum, box_sum, num_pos] of the fused loss.

    att (B, A) and bbx (B, A, 4) float32 contiguous; anchors from
    :func:`pack_anchors`; gt (B, 4) tlbr; w (B,) per-sample weights (ones
    for unweighted). Kernel on CUDA, plain version on the CPU.
    """
    if att.device.type == "cpu":
        return fused_match_loss_reference(
            att, bbx, anchors_tlbr, anchors_cthw, gt, w, match_thr, neg_thr, alpha, gamma
        )
    if att.device.type != "cuda":
        raise ValueError(f"fused_match_loss runs on cuda or cpu, not {att.device}")
    out = _launch(
        att, bbx, anchors_tlbr, anchors_cthw, gt.float().contiguous(),
        w.float().contiguous(), match_thr, neg_thr, alpha, gamma,
    )
    fused_match_loss.launches += 1
    return out


fused_match_loss.launches = 0


def zsg_loss_fused(
    att_logits: Tensor, bbx_reg: Tensor, anchors: tuple[Tensor, Tensor], gt_tlbr: Tensor, *,
    lamb_reg: float = 1.0, match_thr: float = 0.5, neg_thr: float = 0.4,
    alpha: float = 0.25, gamma: float = 2.0, sample_weight: Tensor | None = None,
) -> dict[str, Tensor]:
    """Drop-in for ``ops.losses.zsg_loss`` on the focal, multi-positive path.

    anchors: ``pack_anchors(...)``. Same return dict and normalization:
    both sums divided by the weighted positive count clamped to ≥ 1.
    """
    b = att_logits.shape[0]
    w = (
        sample_weight.float()
        if sample_weight is not None
        else torch.ones((b,), dtype=torch.float32, device=att_logits.device)
    )
    cls_sum, box_sum, num_pos_local = fused_match_loss(
        att_logits.float().contiguous(), bbx_reg.float().contiguous(), *anchors,
        gt_tlbr, w, match_thr, neg_thr, alpha, gamma,
    )
    num_pos = num_pos_local.clamp(min=1.0)
    cls_ls = cls_sum / num_pos
    box_ls = box_sum / num_pos
    return {
        "total": cls_ls + lamb_reg * box_ls,
        "cls_ls": cls_ls,
        "box_ls": box_ls,
        "num_pos": num_pos_local,
    }
