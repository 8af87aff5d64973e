"""One rank of the port's 4-process spatial-partitioning clusters on the CPU.

Not a test module (no ``test_`` prefix). ``tests/test_torch_spatial.py``
starts :func:`run_grads` (the backbone's gradients, validation and the
refusals) and ``tests/test_torch_spatial_step.py`` :func:`run_steps` (the
train step) in four processes through ``torch.multiprocessing``; they
join a gloo process group through a ``FileStore``, run their cases and write
what each rank saw to ``<out>/<case>_rank<r>.pt``. Imports torch and the
port only.
"""

from __future__ import annotations

import numpy as np
import torch

WORLD = 4
VOCAB = 30
STEPS = 2
SEED = 13
# Backbone-gradient cases: (model, mesh_spatial, image (H, W), global batch).
# SSD-VGG16 at S = 4 on two images gathers (B does not divide over the
# members); at S = 2 on 80² under the (2, 2) mesh it reshards.
GRAD_CASES = {
    "s4_64x32": ("retina", 4, (64, 32), 4),
    "s2_64x64": ("retina", 2, (64, 64), 4),
    "ssd_s4_64x32_gathered": ("ssd_vgg", 4, (64, 32), 2),
    "ssd_s2_80x80": ("ssd_vgg", 2, (80, 80), 4),
}
GRAD_B = 4
# Train-step cases under the (data 2, spatial 2) mesh: config overrides and
# the global batch (images). The SSD cases: two images a data index (one a
# member after the reshard), one (gathered), and grouped under grad_accum=2
# (each micro-batch one image a data index: gathered).
STEP_CASES = {
    "sgd": (dict(opt_to_use="sgd"), 4),
    "adam_accum_grouped_remat": (dict(grad_accum=2, queries_per_img=2, remat_backbone=True), 8),
    "ssd_sgd": (dict(mdl_to_use="ssd_vgg", opt_to_use="sgd"), 4),
    "ssd_sgd_one_per_shard": (dict(mdl_to_use="ssd_vgg", opt_to_use="sgd"), 2),
    "ssd_sgd_accum_grouped": (dict(mdl_to_use="ssd_vgg", opt_to_use="sgd", grad_accum=2, queries_per_img=2), 4),
}
# Learner validation at one sample per data index under the (2, 2) mesh
# (global B = 2: gathered in every spatial group), by model.
VALIDATE_B2 = ("retina", "ssd_vgg")
TINY = dict(ds_to_use="synthetic", bs=4, nw=1, lr=1e-6, resize_img=(64, 64), max_qlen=8, lstm_dim=8,
            emb_dim=8, fpn_ch=16, head_ch=16, compute_dtype="float32", log_every=1, seed=3, epochs=1)


def grad_input(hw: tuple[int, int], b: int = GRAD_B) -> np.ndarray:
    """(b, 3, H, W) float64 normal images, from the seed."""
    return np.random.default_rng((SEED, *hw)).normal(size=(b, 3, *hw))


def backbone(sd: dict, fpn_ch: int):
    """The port's ResNet-50 and FPN with the backbone weights of a ZSGNet
    state_dict ``sd``, in float64 and training mode."""
    from zsgnet_tpu_torch.models.fpn import FPN
    from zsgnet_tpu_torch.models.resnet import ResNet50

    enc, fpn = ResNet50(), FPN(fpn_ch)
    for prefix, m in (("backbone.encoder.", enc), ("backbone.fpn.", fpn)):
        m.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    return enc.double().train(), fpn.double().train()


def ssd_backbone(sd: dict):
    """The port's SSD-VGG16 with the backbone weights of a ZSGNet state_dict
    ``sd``, in float64."""
    from zsgnet_tpu_torch.models.ssd_vgg import SSDVGG16

    vgg = SSDVGG16()
    vgg.load_state_dict({k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")})
    return vgg.double().train()


def backbone_grads(sd: dict, fpn_ch: int, x: np.ndarray, sp=None, mdl: str = "retina") -> tuple[dict, float, dict]:
    """Σ over the backbone's outputs (the FPN's, or SSD-VGG16's six maps)
    of Σ p², and its gradients by parameter name (``encoder.*``/``fpn.*``,
    or SSD-VGG16's own), for images ``x`` — this member's rows of its data
    index's images under ``sp``, whose outputs are its batch block. Where
    the group gathered the batch each member's copy of the sum weighs 1/S,
    as the train step weighs its loss."""
    xt = torch.from_numpy(np.ascontiguousarray(x))
    if mdl == "ssd_vgg":
        vgg = ssd_backbone(sd)
        outs, named = vgg(xt, sp), (("", vgg),)
    else:
        enc, fpn = backbone(sd, fpn_ch)
        if sp is None:
            outs = fpn(*enc(xt))
        else:
            feats, flags = enc(xt, sp)
            outs = fpn(*feats, spatial=sp, shard_flags=flags)
        named = (("encoder.", enc), ("fpn.", fpn))
    loss = sum((p * p).sum() for p in outs)
    if sp is not None and sp.gathers(x.shape[0]):
        loss = loss / sp.size
    loss.backward()
    grads = {f"{name}{k}": p.grad.detach().clone() for name, m in named for k, p in m.named_parameters()}
    return grads, float(loss.detach()), {} if sp is None else dict(sp.landed)


def step_cfg(case: str):
    from _torch_port import SMALL

    from zsgnet_tpu_torch.config import Config

    return Config(**{**SMALL, "bs": STEP_CASES[case][1], "lr": 1e-6, **STEP_CASES[case][0]})


def global_batches(cfg) -> list[dict[str, np.ndarray]]:
    """The STEPS global batches of a step case, from the seed."""
    from _torch_port import grouped_batch, random_batch

    out = []
    for i in range(STEPS):
        rng = np.random.default_rng((SEED, i))
        if cfg.queries_per_img > 1:
            out.append(grouped_batch(rng, cfg, cfg.bs, cfg.queries_per_img, VOCAB))
        else:
            out.append(random_batch(rng, cfg.bs, cfg, VOCAB))
    return out


def run_train_steps(cfg, init: dict, batches: list[dict], mesh=None) -> dict:
    """STEPS train steps from ``init`` → per-step losses, the final
    state_dict and where the reshards landed. Under ``mesh`` each batch is
    sliced to the rank's data index; the step cuts the member's rows."""
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for
    from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_train_step

    model = ZSGNet(cfg, VOCAB)
    model.load_state_dict(init)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, anchor_pyramid_for(cfg), "cpu", mesh)
    losses = []
    for b in batches:
        if mesh is not None:
            n = cfg.bs // mesh.data_size
            b = {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in b.items()}
        state, ls = step(state, b)
        losses.append({k: float(v) for k, v in ls.items()})
    return {"losses": losses, "state": {k: v.clone() for k, v in model.state_dict().items()}}


def run_learner_validate(root: str, tmp: str, mesh=None, state: dict | None = None, **kw) -> dict:
    """A fresh Learner's validation summary (on ``mesh``'s data shard), its
    weights (without a mesh) and what touching its ``train_step`` raised;
    ``state`` replaces the Learner's seeded weights."""
    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.train.learner import Learner

    cfg = Config(**{**TINY, "data_dir": root, "tmp_path": tmp, **kw})
    shard = (mesh.data_index, mesh.data_size) if mesh is not None else (0, 1)
    learn = Learner("sp_validate", get_data(cfg, *shard), cfg, device="cpu", mesh=mesh)
    if state is not None:
        learn.model.load_state_dict(state)
    out = {"metrics": learn.validate(), "spatial": None if learn.mesh is None else learn.mesh.spatial,
           "state": learn.model.state_dict() if mesh is None else None, "train_step_error": None}
    try:
        learn.train_step
    except NotImplementedError as e:
        out["train_step_error"] = str(e)
    return out


def _join(rank: int, world: int, store: str):
    import torch.distributed as dist

    from zsgnet_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    return init_distributed("cpu", store=dist.FileStore(store, world), rank=rank, world_size=world)


def run_grads(rank: int, world: int, store: str, init: str, root: str, tmp: str, out: str) -> None:
    """Every GRAD_CASES case on the rank's rows, the gradients summed over
    the world; validation through a Learner on the (2, 2) mesh under
    ``spatial_mode='gspmd'``, and at one sample per data index for each of
    VALIDATE_B2; then the refusals that need a group: retina training below
    S, an indivisible micro-batch, SSD-VGG under ``spatial_mode='halo'`` and
    a mesh larger than the world. ``init`` holds a state_dict per model."""
    import torch.distributed as dist

    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.parallel.halo import group_spatial
    from zsgnet_tpu_torch.parallel.mesh import all_reduce_sum_, make_mesh

    _join(rank, world, store)
    try:
        sds = torch.load(init, weights_only=True)
        for case, (mdl, s, hw, b) in GRAD_CASES.items():
            mesh = make_mesh(Config(mesh_spatial=s, resize_img=hw), "cpu")
            sp = group_spatial(mesh)
            n = b // mesh.data_size
            x = grad_input(hw, b)[mesh.data_index * n:(mesh.data_index + 1) * n]
            grads, loss, landed = backbone_grads(sds[mdl], 16, sp.rows(x, dim=2), sp, mdl)
            all_reduce_sum_(list(grads.values()), mesh.group)
            torch.save({"grads": grads if rank == 0 else None, "loss": loss, "landed": landed,
                        "mesh": (mesh.data_size, mesh.spatial, mesh.data_index, mesh.spatial_index)},
                       f"{out}/{case}_rank{rank}.pt")
        # The JAX 'gspmd' mode: evaluation runs, only the train step refuses.
        mesh = make_mesh(Config(**TINY, mesh_spatial=2), "cpu")
        torch.save(run_learner_validate(root, tmp, mesh, mesh_spatial=2, spatial_mode="gspmd"),
                   f"{out}/validate_rank{rank}.pt")
        for mdl in VALIDATE_B2:
            torch.save(run_learner_validate(root, tmp, mesh, state=sds[f"{mdl}_tiny"], mesh_spatial=2,
                                            mdl_to_use=mdl, bs=2),
                       f"{out}/validate_b2_{mdl}_rank{rank}.pt")
        errors = {}
        for name, fn in _refusals(sds["retina"]):
            try:
                fn()
                errors[name] = None
            except (ValueError, NotImplementedError) as e:
                errors[name] = f"{type(e).__name__}: {e}"
        torch.save(errors, f"{out}/errors_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _refusals(sd: dict):
    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for
    from zsgnet_tpu_torch.parallel.mesh import make_mesh
    from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_train_step

    def below_s(**kw):
        cfg = step_cfg("sgd").replace(mesh_spatial=2, **kw)
        model = ZSGNet(cfg, VOCAB)
        model.load_state_dict(sd)
        step = make_train_step(cfg, anchor_pyramid_for(cfg), "cpu", make_mesh(cfg, "cpu"))
        n = cfg.bs // 2
        step(create_train_state(cfg, model), {k: v[:n] for k, v in global_batches(cfg)[0].items()})

    def ssd_halo():
        from zsgnet_tpu_torch.parallel.halo import group_spatial

        cfg = step_cfg("ssd_sgd").replace(mesh_spatial=2, spatial_mode="halo")
        b = global_batches(cfg)[0]
        sp = group_spatial(make_mesh(cfg, "cpu"))
        ZSGNet(cfg, VOCAB).train()(torch.from_numpy(sp.rows(b["img"][:2])), torch.from_numpy(b["qvec"][:2]),
                                   torch.from_numpy(b["qlens"][:2]), spatial=sp)

    return [
        ("micro_batch", lambda: below_s(grad_accum=2)),  # 4 / 2 data / 2 micro = 1 < S
        ("below_s", lambda: below_s(bs=2)),  # 2 / 2 data = 1 < S
        ("ssd_halo", ssd_halo),
        ("oversubscribed", lambda: make_mesh(Config(mesh_spatial=2, mesh_shape=(4,)), "cpu")),
        ("indivisible", lambda: make_mesh(Config(mesh_spatial=3), "cpu")),
    ]


def run_steps(rank: int, world: int, store: str, init: str, out: str) -> None:
    """Every STEP_CASES case under the (2, 2) mesh; ``init`` holds a
    state_dict per model."""
    import torch.distributed as dist

    from zsgnet_tpu_torch.parallel.mesh import make_mesh

    _join(rank, world, store)
    try:
        sds = torch.load(init, weights_only=True)
        for case in STEP_CASES:
            cfg = step_cfg(case).replace(mesh_spatial=2)
            res = run_train_steps(cfg, sds[cfg.mdl_to_use], global_batches(cfg), make_mesh(cfg, "cpu"))
            if rank:  # rank 0's state is the one compared; the others' must be its bytes
                from _torch_mh_worker import fingerprint

                res["state"] = fingerprint(res["state"])
            torch.save(res, f"{out}/{case}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def two_rank_mesh(rank: int, store: str, out: str) -> None:
    """One of two ranks: the (data 1, spatial 2) mesh of ``make_mesh``."""
    import torch.distributed as dist

    from zsgnet_tpu_torch.config import Config
    from zsgnet_tpu_torch.parallel.mesh import make_mesh

    _join(rank, 2, store)
    try:
        m = make_mesh(Config(mesh_spatial=2), "cpu")
        torch.save({"spatial": m.spatial, "data_size": m.data_size, "data_index": m.data_index,
                    "spatial_index": m.spatial_index, "backend": dist.get_backend(m.spatial_group)},
                   f"{out}/mesh_rank{rank}.pt")
    finally:
        dist.destroy_process_group()
