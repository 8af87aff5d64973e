"""Spatial partitioning — port of ``zsgnet_tpu/parallel/halo.py``.

``cfg.mesh_spatial = S > 1`` spreads one sample's activations over S
members of a spatial group, the one parallelism that data parallelism
cannot give. The scheme is the JAX package's, and the split does not show
in the numbers:

* the image enters height-sharded: each member holds all B samples of its
  group but only H/S of their rows (dim 2 of NCHW, dim 1 of the JAX NHWC);
* every op that crosses the height (the 7×7/2 stem, the 3×3/2 maxpool,
  each bottleneck's 3×3 conv, the FPN's 3×3 smooth convs, P6 and P7) first
  takes halo rows from its ring neighbours (:meth:`SpatialCtx.halo`) and
  runs with zero height padding: the ring ends receive zeros, the conv's
  own padding, or ``-inf`` for the maxpool;
* at the first op whose local height :func:`halo_plan` rejects, the tensor
  is resharded by one all-to-all (:meth:`SpatialCtx.reshard`): split the
  batch, concatenate the height. Each member then holds B/S samples at
  full height, and the head, the loss and the optimizer run on those
  blocks unchanged. A ``(data, spatial)`` mesh is a ``(data·spatial,)``
  data mesh from there on, so losses, gradients and BatchNorm moments are
  summed over every rank;
* a batch that S does not divide (one sample per data index, as the JAX
  GSPMD steps take it) is gathered instead: every member all-gathers the
  height and carries the whole batch from there (:meth:`SpatialCtx.gathers`).
  Its backward is a reduce-scatter, so the convolutions before the gather
  get exact gradients; a loss after it weighs each member's copy 1/S
  (``parallel/train_step.py``), so sums over the world count each sample
  once.

ResNet-50 and its FPN (``models/resnet.py``, ``models/fpn.py``) and
SSD-VGG16 (``models/ssd_vgg.py``, the dilated conv6 and the max pools
through :func:`conv_rows` and :func:`max_pool_rows`) run split this way.

Two backends implement the one interface:

* :class:`GroupSpatial`, a process group: one process per device, the
  spatial sub-group of the ``(data, spatial)`` grid of ranks
  (``parallel.mesh.make_mesh``), ``batch_isend_irecv`` for the halos and
  ``all_to_all_single`` for the reshard and the gather. Training and the
  Learner's evaluation run on it. Gloo moves only host tensors between
  processes, so under gloo a device tensor is staged through host memory
  inside the exchange (and 16-bit floats travel as int16 bits); under NCCL
  device tensors go straight in.
* :class:`LocalSpatial`, one process: S threads, one per member device,
  exchanging rows by device-to-device copies under a barrier. It is
  forward-only and serves the ``Grounder`` and ``serve.py``, as the JAX
  ones serve a spatial mesh from one process. Its devices may repeat.

Every exchange runs under the profiler labels ``sp::halo`` and
``sp::reshard``. Every member issues the same exchanges in the same order:
where a reshard lands depends on static heights only.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from zsgnet_tpu_torch.models.quant import QuantConv2d

Tensor = torch.Tensor


def halo_plan(h_local: int, k: int, stride: int, pad: int, dilation: int = 1) -> tuple[int, int] | None:
    """Halo row counts (top, bottom) for a k/stride/pad height-conv on a
    shard of ``h_local`` rows — or None when the op cannot run sharded.

    A dilated conv reads a window of ``d·(k−1)+1`` rows, its effective
    kernel ``k``. Output row j (global) reads input rows ``stride*j - pad ..
    stride*j - pad + k - 1``; with contiguous equal shards the first
    owned output row needs ``pad`` rows from above and the last needs
    ``k - stride - pad`` from below (clamped at 0). Shardable iff the
    local output height is exact (``h_local % stride == 0``), the halos
    fit in ONE neighbor's rows, and the VALID conv over the halo-padded
    block reproduces exactly ``h_local/stride`` rows.
    """
    k = dilation * (k - 1) + 1
    ht, hb = max(pad, 0), max(k - stride - pad, 0)
    if h_local % stride or h_local < max(ht, hb, 1):
        return None
    if (h_local + ht + hb - k) // stride + 1 != h_local // stride:
        return None
    return ht, hb


def spatial_train_mode(cfg) -> str:
    """Which spatial TRAINING implementation a config selects.

    ``halo``  — this module: shard_map + explicit collectives. Default
                for retina, whose GSPMD gradient is mis-compiled by the
                jax-0.9 partitioner (tools/check_spatial_gspmd.py).
    ``gspmd`` — jit + in_shardings auto-partitioning. Default for
                ssd_vgg, where it is measured-exact (no FPN upsample in
                the backward — tests/test_spatial.py).
    Eval/serving always uses GSPMD (forward-only, exact for both).

    The port has no GSPMD: its ``gspmd`` mode (SSD-VGG) splits the VGG
    tower by rows with the halo exchanges of this module, up to the first
    layer a shard cannot take (``models/ssd_vgg.py``).
    """
    if cfg.spatial_mode != "auto":
        return cfg.spatial_mode
    return "halo" if cfg.mdl_to_use == "retina" else "gspmd"


def reshard_batch_error(b: int, size: int) -> ValueError:
    return ValueError(
        f"spatial reshard needs the per-member batch {b} "
        f"divisible by mesh_spatial={size} (raise cfg.bs or lower mesh_spatial)"
    )


def conv_rows(conv: torch.nn.Conv2d, x: Tensor, spatial: "SpatialCtx | None") -> Tensor:
    """``conv`` on ``x``, a height shard of ``spatial``'s group (the whole
    tensor, ``conv(x)``, where ``spatial`` is None). On a shard a conv
    taller than one row first takes the halo rows :func:`halo_plan` gives
    (the caller checked that it admits the op) and runs with no height
    padding, the module's own width padding.

    An int8 conv (``QuantConv2d``) takes the activation scale of the global
    input height, the shard's rows times the group size. Calibration runs on
    the unsharded model; with the scale global, the per-tensor quantization
    is elementwise and the int32 product exact, so a shard's rows come out
    as the one-device int8 model's (the JAX ``Grounder`` serves int8 on a
    ``(data, spatial)`` mesh with global scales)."""
    if spatial is None:
        return conv(x)
    rows = x.shape[2] * spatial.size
    x = spatial.halo(x, *halo_plan(x.shape[2], conv.kernel_size[0], conv.stride[0], conv.padding[0],
                                   conv.dilation[0]))
    pad = (0, conv.padding[1])
    if isinstance(conv, QuantConv2d):
        return conv(x, padding=pad, rows=rows)
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, pad, conv.dilation, conv.groups)


def max_pool_rows(x: Tensor, spatial: "SpatialCtx", k: int = 3, stride: int = 2, pad: int = 1) -> Tensor:
    """A k/stride/pad max pool (default the stem's 3×3/2/1) on a height
    shard: the rows :func:`halo_plan` gives, ``-inf`` at the ring ends, then
    no height padding; the width is padded with ``-inf`` as
    ``nn.MaxPool2d(k, stride, pad)`` pads. The caller checked that
    :func:`halo_plan` admits the op."""
    x = spatial.halo(x, *halo_plan(x.shape[2], k, stride, pad), fill=float("-inf"))
    return F.max_pool2d(x, k, stride, padding=(0, pad))


class SpatialCtx:
    """One member's view of its spatial group: ``size`` members, this one's
    ``index``, and the three operations of the JAX ``SpatialCtx`` on dim 2
    of NCHW. ``bn_group`` is the process group of training-mode BatchNorm
    moments (every rank of both axes), None where nothing trains.

    Subclasses move the rows: :meth:`_swap` and :meth:`_all_to_all`."""

    size: int
    index: int
    bn_group: Any = None
    # Where each reshard or gather landed (the caller's label → the local
    # input shape).
    landed: dict[str, tuple[int, ...]]

    def gathers(self, b: int) -> bool:
        """Whether a batch of ``b`` samples is gathered rather than split:
        S does not divide it, so :meth:`reshard` gives every member the whole
        batch at full height and :meth:`slice_batch` the whole batch."""
        return b % self.size != 0

    def counted(self, x, images: int):
        """The rows of a per-sample result replicated over the group (a
        tensor or an array, the batch first: per pair, pair-major, for a
        grouped batch) that this member answers for, so that the group
        counts each sample once: its block of a batch of ``images`` images
        that splits, or, where the batch was gathered, every row on member 0
        and none on the others."""
        if not self.gathers(images):
            sub = x.shape[0] // self.size
            return x[self.index * sub:(self.index + 1) * sub]
        return x if self.index == 0 else x[:0]

    def halo(self, x: Tensor, ht: int, hb: int, fill: float = 0.0) -> Tensor:
        """``ht`` rows from the member above and ``hb`` from the one below,
        concatenated around ``x``'s rows. The ring ends get ``fill`` rows:
        zeros, the conv's own padding, or ``-inf`` for the maxpool, whose
        true pad can never win a maximum. (A zero there ties with a
        post-ReLU zero maximum and can route the pooling backward into a
        halo row whose gradient the ring end drops: 3.8 % gradient error
        in the JAX package before the fix.)"""
        if not (ht or hb):
            return x
        return _Halo.apply(x, self, ht, hb, fill)

    def reshard(self, x: Tensor, where: str = "") -> Tensor:
        """Split the batch, gather the height, in one all-to-all: each member
        ends with its B/S block of samples at full height (the block
        :meth:`slice_batch` takes). A batch that does not divide
        (:meth:`gathers`) is gathered instead: every member ends with the
        whole batch at full height; in the backward each member gets the sum
        over the group of its rows' gradients (a reduce-scatter)."""
        self.landed[where] = tuple(x.shape)
        if self.gathers(x.shape[0]):
            return _Gather.apply(x, self)
        return _Reshard.apply(x, self)

    def slice_batch(self, x: Tensor) -> Tensor:
        """This member's batch block of a tensor replicated over the group —
        the same block :meth:`reshard` keeps (the whole batch where it
        gathers)."""
        b = x.shape[0]
        if self.gathers(b):
            return x
        sub = b // self.size
        return x[self.index * sub:(self.index + 1) * sub]

    def rows(self, img, dim: int = 1):
        """This member's rows of a full-height image batch (NHWC: ``dim``
        1), a numpy array or a tensor."""
        h = img.shape[dim]
        if h % self.size:
            raise ValueError(f"image height {h} not divisible by mesh_spatial={self.size}")
        sub = h // self.size
        idx = [slice(None)] * img.ndim
        idx[dim] = slice(self.index * sub, (self.index + 1) * sub)
        return img[tuple(idx)]

    # -- the rows' transport ------------------------------------------------
    def _swap(self, down: Tensor | None, up: Tensor | None) -> tuple[Tensor | None, Tensor | None]:
        """Send ``down`` to the member below and ``up`` to the one above;
        → (what the member above sent down, what the member below sent up),
        None at a ring end or where nothing of that kind is sent. Every
        member passes tensors of the same shapes."""
        raise NotImplementedError

    def _all_to_all(self, blocks: Tensor) -> Tensor:
        """``blocks`` (size, ...): block j goes to member j; → (size, ...)
        whose block i came from member i."""
        raise NotImplementedError


class _Halo(torch.autograd.Function):
    """Rows forward; in the backward each received row's gradient goes back
    to its sender and is added to the boundary row it came from. A ring
    end's fill rows have no sender: their gradient is dropped."""

    @staticmethod
    def forward(ctx, x: Tensor, sp: SpatialCtx, ht: int, hb: int, fill: float) -> Tensor:
        ctx.sp, ctx.ht, ctx.hb, ctx.h = sp, ht, hb, x.shape[2]
        with record_function("sp::halo"):
            top, bottom = sp._swap(x[:, :, x.shape[2] - ht:].contiguous() if ht else None,
                                   x[:, :, :hb].contiguous() if hb else None)
        parts = []
        if ht:
            parts.append(top if top is not None else x.new_full((*x.shape[:2], ht, x.shape[3]), fill))
        parts.append(x)
        if hb:
            parts.append(bottom if bottom is not None else x.new_full((*x.shape[:2], hb, x.shape[3]), fill))
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g: Tensor):
        sp, ht, hb, h = ctx.sp, ctx.ht, ctx.hb, ctx.h
        with record_function("sp::halo"):
            # The top halo's gradient goes up to its sender, the bottom's down.
            from_above, from_below = sp._swap(g[:, :, ht + h:].contiguous() if hb else None,
                                              g[:, :, :ht].contiguous() if ht else None)
        dx = g[:, :, ht:ht + h].clone()
        if from_above is not None:  # the gradient of the rows I sent up
            dx[:, :, :hb] += from_above
        if from_below is not None:  # ... and of the rows I sent down
            dx[:, :, h - ht:] += from_below
        return dx, None, None, None, None


class _Reshard(torch.autograd.Function):
    """(B, C, h, W) height shard → (B/S, C, S·h, W) batch block, by one
    all-to-all; the backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x: Tensor, sp: SpatialCtx) -> Tensor:
        s = sp.size
        b, c, h, w = x.shape
        ctx.sp = sp
        with record_function("sp::reshard"):
            got = sp._all_to_all(x.contiguous().view(s, b // s, c, h, w))
        return got.permute(1, 2, 0, 3, 4).reshape(b // s, c, s * h, w)

    @staticmethod
    def backward(ctx, g: Tensor):
        sp = ctx.sp
        s = sp.size
        bs, c, hs, w = g.shape
        with record_function("sp::reshard"):
            got = sp._all_to_all(g.reshape(bs, c, s, hs // s, w).permute(2, 0, 1, 3, 4).contiguous())
        return got.reshape(s * bs, c, hs // s, w), None


class _Gather(torch.autograd.Function):
    """(B, C, h, W) height shard → (B, C, S·h, W), the whole batch at full
    height on every member, by one all-to-all of S copies; the backward
    sends each member its rows' gradient from every member and sums them in
    member order (a reduce-scatter through the same all-to-all)."""

    @staticmethod
    def forward(ctx, x: Tensor, sp: SpatialCtx) -> Tensor:
        s = sp.size
        b, c, h, w = x.shape
        ctx.sp = sp
        with record_function("sp::reshard"):
            got = sp._all_to_all(x.contiguous()[None].expand(s, b, c, h, w).contiguous())
        return got.permute(1, 2, 0, 3, 4).reshape(b, c, s * h, w)

    @staticmethod
    def backward(ctx, g: Tensor):
        sp = ctx.sp
        s = sp.size
        b, c, hs, w = g.shape
        with record_function("sp::reshard"):
            got = sp._all_to_all(g.reshape(b, c, s, hs // s, w).permute(2, 0, 1, 3, 4).contiguous())
        return got.sum(dim=0), None


class GroupSpatial(SpatialCtx):
    """A member of a spatial process group (backend (a)): ``group`` holds the
    ``size`` consecutive global ranks starting at ``first_rank``; this
    process is member ``index``. ``bn_group`` takes the BatchNorm moments
    (the whole world)."""

    def __init__(self, group, first_rank: int, size: int, index: int, bn_group=None):
        self.group, self.first_rank, self.size, self.index = group, first_rank, size, index
        self.bn_group = bn_group
        self.landed = {}
        self.staged = dist.get_backend(group) == "gloo"
        self._staging_logged = False

    def _wire(self, t: Tensor) -> Tensor:
        """``t`` as gloo moves it: on the host, 16-bit floats as their int16
        bits. Identity under NCCL."""
        if not self.staged:
            return t
        if t.is_cuda and not self._staging_logged:
            self._staging_logged = True
            print("spatial: gloo group — halo and reshard rows staged through host memory", flush=True)
        t = t.cpu()
        return t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.float16) else t

    def _unwire(self, t: Tensor, like: Tensor) -> Tensor:
        if not self.staged:
            return t
        return t.view(like.dtype).to(like.device) if t.dtype != like.dtype else t.to(like.device)

    def _swap(self, down, up):
        peer_above = self.first_rank + self.index - 1 if self.index > 0 else None
        peer_below = self.first_rank + self.index + 1 if self.index < self.size - 1 else None
        ops, recv = [], {}
        if down is not None and peer_below is not None:
            ops.append(dist.P2POp(dist.isend, self._wire(down), peer_below, self.group))
        if up is not None and peer_above is not None:
            ops.append(dist.P2POp(dist.isend, self._wire(up), peer_above, self.group))
        if down is not None and peer_above is not None:
            recv["above"] = (self._wire(torch.empty_like(down)), down)
            ops.append(dist.P2POp(dist.irecv, recv["above"][0], peer_above, self.group))
        if up is not None and peer_below is not None:
            recv["below"] = (self._wire(torch.empty_like(up)), up)
            ops.append(dist.P2POp(dist.irecv, recv["below"][0], peer_below, self.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = {k: self._unwire(buf, like) for k, (buf, like) in recv.items()}
        return out.get("above"), out.get("below")

    def _all_to_all(self, blocks):
        wire = self._wire(blocks)
        got = torch.empty_like(wire)
        dist.all_to_all_single(got, wire, group=self.group)
        return self._unwire(got, blocks)


def group_spatial(mesh) -> GroupSpatial | None:
    """The spatial context of a :class:`~zsgnet_tpu_torch.parallel.mesh.DataMesh`
    whose ``spatial`` is above 1, else None."""
    if mesh is None or mesh.spatial <= 1:
        return None
    return GroupSpatial(mesh.spatial_group, mesh.data_index * mesh.spatial, mesh.spatial,
                        mesh.spatial_index, bn_group=mesh.group)


class _LocalGroup:
    """What the members of one in-process spatial group share: a barrier and
    the slots rows are posted in."""

    def __init__(self, size: int, timeout: float):
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots: list[Any] = [None] * size

    def exchange(self, index: int, item: Any) -> list[Any]:
        """Post ``item``; → every member's items, in member order. Nobody
        reposts before everybody has read."""
        self.slots[index] = item
        self.barrier.wait()
        items = list(self.slots)
        self.barrier.wait()
        return items


class LocalSpatial(SpatialCtx):
    """A member of an in-process spatial group (backend (b)), run on one of
    the group's threads: ``device`` is its device (devices may repeat).
    Forward-only. A batch that does not divide over the group (bucket 1 at
    S = 2) is gathered (:meth:`SpatialCtx.gathers`): every member carries
    the whole batch at full height and returns the same rows."""

    def __init__(self, shared: _LocalGroup, size: int, index: int, device: torch.device):
        self.shared, self.size, self.index, self.device = shared, size, index, device
        self.landed = {}

    def _swap(self, down, up):
        items = self.shared.exchange(self.index, (down, up))
        above = items[self.index - 1][0] if self.index > 0 else None
        below = items[self.index + 1][1] if self.index < self.size - 1 else None
        return (None if above is None else above.to(self.device),
                None if below is None else below.to(self.device))

    def _all_to_all(self, blocks):
        items = self.shared.exchange(self.index, blocks)
        return torch.stack([b[self.index].to(self.device) for b in items])


class LocalMesh:
    """In-process ``(data, spatial)`` members over ``devices`` (D·S of them,
    data-major: member s of replica d is ``devices[d·S + s]``), each run on a
    thread of its own. :meth:`run` calls ``fn(d, ctx)`` on every member at
    once and returns the results as ``[d][s]``. A member that raises breaks
    its group's barrier, so the others raise too instead of waiting;
    ``timeout`` bounds every wait."""

    def __init__(self, devices: list[torch.device], spatial: int, timeout: float = 600.0):
        if len(devices) % spatial:
            raise ValueError(f"{len(devices)} devices do not divide into spatial groups of {spatial}")
        self.devices, self.spatial, self.timeout = list(devices), spatial, timeout
        self.data = len(devices) // spatial
        self._pool = ThreadPoolExecutor(len(devices), thread_name_prefix="spatial")

    def run(self, fn: Callable[[int, LocalSpatial], Any]) -> list[list[Any]]:
        s = self.spatial
        groups = [_LocalGroup(s, self.timeout) for _ in range(self.data)]

        def member(i: int):
            d = i // s
            ctx = LocalSpatial(groups[d], s, i % s, self.devices[i])
            try:
                on_device = torch.cuda.device(ctx.device) if ctx.device.type == "cuda" else contextlib.nullcontext()
                with torch.inference_mode(), on_device:
                    return fn(d, ctx)
            except BaseException:
                groups[d].barrier.abort()
                raise

        futures = [self._pool.submit(member, i) for i in range(len(self.devices))]
        results = []
        errors = []
        for f in futures:
            try:
                results.append(f.result())
            except threading.BrokenBarrierError as e:
                errors.append(e)
                results.append(None)
            except Exception as e:  # noqa: BLE001 — re-raised below, before the barrier errors it caused
                errors.insert(0, e)
                results.append(None)
        if errors:
            raise errors[0]
        return [results[d * s:(d + 1) * s] for d in range(self.data)]

    def close(self) -> None:
        self._pool.shutdown(wait=True)

