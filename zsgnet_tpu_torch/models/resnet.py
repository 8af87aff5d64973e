"""ResNet-50 backbone — torch port of ``zsgnet_tpu/models/resnet.py``.

torchvision's layout and parameter names (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv{1,2,3}``/``bn{1,2,3}``/``downsample.{0,1}``),
bottleneck v1.5 (stride in the 3×3), BatchNorm with eps 1e-5 and the JAX
package's momentum 0.9 (torch's 0.1) that normalizes with the batch's
moments in training and with its running statistics in eval mode. Returns
the C3/C4/C5 taps (512/1024/2048 channels, strides 8/16/32), NCHW.

``ResNet50(remat=True)`` recomputes each bottleneck's activations in the
backward pass instead of keeping them (``torch.utils.checkpoint``, the JAX
package's ``nn.remat`` per block), in training mode only. The recomputed
forward leaves the BatchNorm statistics alone: the momentum update is
applied once per step, as flax's side-effect-free remat does.

``quant_mode`` builds every convolution through ``models.quant.conv_for``
(the JAX package quantizes the same ones: the stem, each bottleneck's three
and its downsample).

``ResNet50(sync_bn=True)`` (a model built with ``cfg.bn_sync_axis`` set, as
the Learner does under a data mesh) takes its training-mode BatchNorm
moments over every rank of the process group, as the JAX package's
BatchNorm with ``axis_name`` does under ``shard_map``.

``forward(x, spatial)`` (a ``parallel.halo.SpatialCtx``) takes a
height-sharded image: every height-crossing op exchanges halo rows and runs
with zero height padding, the first one whose local height
``halo_plan`` rejects is preceded by the reshard, and the taps come back
with their flags (still sharded or not), as the JAX ``ResNet50`` returns
them. The training-mode BatchNorm moments are then taken over every rank of
both axes (``spatial.bn_group``) whether or not ``sync_bn`` is set: before
the reshard the members hold different rows of the same samples.
The stem is always the plain 7×7/2 conv, which the JAX
space-to-depth stem (``spd_stem``) rewrites exactly; under ``spatial`` an
``spd_stem`` model enters by the reshard at the input, as the JAX one does. Under ``remat`` the recomputation of a block
exchanges its halos again, in the same order on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from zsgnet_tpu_torch.models.quant import conv_for
from zsgnet_tpu_torch.parallel.halo import conv_rows, halo_plan, max_pool_rows
from zsgnet_tpu_torch.parallel.mesh import all_reduce_

Tensor = torch.Tensor


class _SyncBatchNorm(torch.autograd.Function):
    """Training-mode batch normalization with moments over every rank of
    ``group``, through ``all_reduce`` alone: the forward sums the
    per-channel values and the count, then the squares centred on the
    global mean (flax's exact two-pass variance); the backward sums Σdy and
    Σdy·x̂. The weight and bias gradients stay this rank's partials, which
    the train step sums over the ranks with every other gradient. Computes
    in float32 (float64 for a float64 ``x``) and returns ``x``'s dtype;
    → (y, mean, biased variance)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        c = x.shape[1]
        stats = torch.cat([x32.sum(dims), x32.new_full((1,), x.numel() // c)])
        all_reduce_(stats, group)
        count = stats[c]
        mean = stats[:c] / count
        xc = x32 - mean[None, :, None, None]
        sq = xc.square().sum(dims)
        all_reduce_(sq, group)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        y = xc * invstd[None, :, None, None] * weight.to(x32.dtype)[None, :, None, None] + \
            bias.to(x32.dtype)[None, :, None, None]
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, count = ctx.saved_tensors
        dims = (0, 2, 3)
        c = x.shape[1]
        dy32 = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - mean[None, :, None, None]) * invstd[None, :, None, None]
        local = torch.cat([dy32.sum(dims), (dy32 * xhat).sum(dims)])
        dbias, dweight = local[:c].clone(), local[c:].clone()
        all_reduce_(local, ctx.group)
        mean_dy, mean_dy_xhat = local[:c] / count, local[c:] / count
        dx = (dy32 - mean_dy[None, :, None, None] - xhat * mean_dy_xhat[None, :, None, None]) * (
            invstd * weight.to(mean.dtype))[None, :, None, None]
        return dx.to(x.dtype), dweight.to(weight.dtype), dbias.to(weight.dtype), None, None


def _sync_group(spatial=None):
    """The process group to take BatchNorm moments over: under ``spatial``
    its ``bn_group`` (the whole world: both mesh axes), else the default
    group when more than one rank is up, else None (one rank's moments are
    the global ones)."""
    if spatial is not None:
        return spatial.bn_group
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode update of ``running_var`` uses
    the biased batch variance, as flax's ``nn.BatchNorm`` does; torch's uses
    the unbiased one, n/(n−1) larger for n values per channel.

    The forward stays torch's ``batch_norm`` (cuDNN on the card), which
    updates a copy of ``running_var``: with m the momentum and v_u the
    unbiased variance it writes (1−m)·old + m·v_u there, and
    (1−m)·old + m·v_u·(n−1)/n, what flax writes, goes into ``running_var``.
    (The op's autograd node holds the copy, so the buffer itself may
    change in place.) Every ``bn_variance`` mode of the config trains with
    this exact variance: ``shifted`` is algebraically equal to it, and
    ``fast``/``shifted16`` differ from it only by rounding in the JAX
    package.

    With ``sync`` set and more than one rank in the process group, the
    training-mode moments are global (:class:`_SyncBatchNorm`) and the
    running statistics move with them, so they stay equal on every rank;
    with one rank the forward is the plain one above and issues no
    collective.

    While ``frozen_stats`` is set (the recomputation under remat) the
    training-mode forward normalizes with the batch's moments as usual and
    updates nothing.

    ``forward(x, spatial)`` synchronizes over ``spatial.bn_group`` in
    training mode, ``sync`` or not."""

    frozen_stats = False

    def __init__(self, num_features: int, sync: bool = False):
        super().__init__(num_features)
        self.sync = sync

    def forward(self, x: Tensor, spatial=None) -> Tensor:
        if not self.training:
            return super().forward(x)
        group = _sync_group(spatial) if (self.sync or spatial is not None) else None
        if group is not None:
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias, self.eps, group)
            if not self.frozen_stats:
                self.num_batches_tracked.add_(1)
                with torch.no_grad():
                    self.running_mean.lerp_(mean, self.momentum)
                    self.running_var.lerp_(var, self.momentum)
            return y
        if self.frozen_stats:
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
        self.num_batches_tracked.add_(1)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        keep = 1.0 - self.momentum
        with torch.no_grad():
            delta = (var - keep * self.running_var) * ((n - 1) / n)
            self.running_var.mul_(keep).add_(delta)
        return y


@contextlib.contextmanager
def frozen_bn_stats(module: nn.Module) -> Iterator[None]:
    """The BatchNorm layers of ``module`` update no statistics inside."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.frozen_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen_stats = False


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1, quant_mode: str = "off",
                 sync_bn: bool = False):
        super().__init__()
        out_ch = width * self.expansion
        self.stride = stride
        self.conv1 = conv_for(quant_mode, in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width, sync_bn)
        self.conv2 = conv_for(quant_mode, width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(width, sync_bn)
        self.conv3 = conv_for(quant_mode, width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm2d(out_ch, sync_bn)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                conv_for(quant_mode, in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm2d(out_ch, sync_bn),
            )

    def forward(self, x: Tensor, spatial=None, sharded: bool = False) -> Tensor:
        """``spatial``: BatchNorm moments over its ``bn_group``; with
        ``sharded`` the input is height-sharded and every conv runs on the
        shard through ``conv_rows``, the 3×3 exchanging halos (the caller
        checked ``halo_plan``)."""
        sp = spatial if sharded else None
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv_rows(self.downsample[0], x, sp), spatial)
        y = self.relu(self.bn1(conv_rows(self.conv1, x, sp), spatial))
        y = self.relu(self.bn2(conv_rows(self.conv2, y, sp), spatial))
        y = self.bn3(conv_rows(self.conv3, y, sp), spatial)
        return self.relu(y + identity)


class ResNet50(nn.Module):
    """(B, 3, H, W) normalized image → (C3, C4, C5)."""

    def __init__(self, remat: bool = False, quant_mode: str = "off", sync_bn: bool = False,
                 spd_stem: bool = False):
        super().__init__()
        self.remat = remat
        self.spd_stem = spd_stem
        self.conv1 = conv_for(quant_mode, 3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, sync_bn)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for stage_i, (n_blocks, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
            blocks = []
            for block_i in range(n_blocks):
                stride = 2 if (block_i == 0 and stage_i > 0) else 1
                blocks.append(Bottleneck(in_ch, width, stride, quant_mode, sync_bn))
                in_ch = width * Bottleneck.expansion
            setattr(self, f"layer{stage_i + 1}", nn.Sequential(*blocks))

    def _block(self, block: Bottleneck, x: Tensor, spatial=None, sharded: bool = False) -> Tensor:
        args = (x,) if spatial is None else (x, spatial, sharded)
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(*args)
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), frozen_bn_stats(block)))

    def forward(self, x: Tensor, spatial=None):
        """→ (C3, C4, C5); under ``spatial`` → ((C3, C4, C5), flags), flag i
        true where tap i is still height-sharded."""
        sharded = spatial is not None
        if sharded and self.spd_stem:  # the JAX SPD stem has no halo variant: batch-split from the input
            x, sharded = spatial.reshard(x, "spd_stem"), False
        if sharded and halo_plan(x.shape[2], 7, 2, 3) is None:
            x, sharded = spatial.reshard(x, "stem"), False
        x = conv_rows(self.conv1, x, spatial if sharded else None)
        x = self.relu(self.bn1(x, spatial))
        if sharded and halo_plan(x.shape[2], 3, 2, 1) is None:
            x, sharded = spatial.reshard(x, "maxpool"), False
        x = max_pool_rows(x, spatial) if sharded else self.maxpool(x)
        feats, flags = [], []
        for stage_i in range(4):
            for block_i, block in enumerate(getattr(self, f"layer{stage_i + 1}")):
                if sharded and halo_plan(x.shape[2], 3, block.stride, 1) is None:
                    x, sharded = spatial.reshard(x, f"layer{stage_i + 1}.{block_i}"), False
                x = self._block(block, x, spatial, sharded)
            if stage_i >= 1:
                feats.append(x)
                flags.append(sharded)
        return tuple(feats) if spatial is None else (tuple(feats), tuple(flags))
