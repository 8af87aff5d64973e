"""One rank of the port's 2-process data-parallel cluster on the CPU.

Not a test module (no ``test_`` prefix). ``tests/test_torch_multihost.py``
starts :func:`run` in two processes through ``torch.multiprocessing``; they
join a gloo process group through a ``FileStore`` and run every case of
``STEP_CASES`` and ``LEARNER_CASES`` in turn, each rank writing what it saw
to ``<out>/<case>_rank<r>.pt``. Imports torch and the port only.
"""

from __future__ import annotations

import numpy as np
import torch

VOCAB = 30
STEPS = 2
SEED = 11
# Per case: config overrides and the global batch (images).
STEP_CASES = {
    "fused": (dict(opt_to_use="sgd"), 4),
    "grad_accum2": (dict(grad_accum=2), 4),
    "softmax": (dict(use_softmax=True, use_focal=False), 4),
    "grouped": (dict(queries_per_img=2), 4),
}
LEARNER_CASES = ("validate", "resume")
TINY = dict(ds_to_use="synthetic", bs=4, nw=1, lr=1e-6, resize_img=(64, 64), max_qlen=8, lstm_dim=8,
            emb_dim=8, fpn_ch=16, head_ch=16, compute_dtype="float32", log_every=1, seed=3, epochs=1)


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


def run_steps(cfg, init: dict, batches: list[dict], mesh=None) -> dict:
    """STEPS train steps from ``init`` (a state_dict) → per-step losses and
    the final state_dict. Under ``mesh`` each batch is sliced to the rank's
    rows and the model takes its BatchNorm moments over the ranks."""
    from zsgnet_tpu_torch.models.zsgnet import ZSGNet, anchor_pyramid_for
    from zsgnet_tpu_torch.parallel.train_step import create_train_state, make_train_step

    model = ZSGNet(cfg.replace(bn_sync_axis=cfg.data_axis) if mesh is not None else cfg, VOCAB)
    model.load_state_dict(init)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, anchor_pyramid_for(cfg), "cpu", mesh)
    losses = []
    for b in batches:
        if mesh is not None:
            n = cfg.bs // mesh.world_size
            b = {k: v[mesh.rank * n:(mesh.rank + 1) * n] for k, v in b.items()}
        state, ls = step(state, b)
        losses.append({k: float(v) for k, v in ls.items()})
    return {"losses": losses, "state": {k: v.clone() for k, v in model.state_dict().items()}}


def fingerprint(state: dict) -> str:
    """A hash of every tensor's bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].contiguous().numpy().tobytes())
    return h.hexdigest()


def learner_cfg(case: str, root: str, tmp: str):
    from zsgnet_tpu_torch.config import Config

    return Config(**TINY, data_dir=root, tmp_path=tmp)


def run_learner(case: str, root: str, tmp: str, rank: int = 0, world: int = 1) -> dict:
    """``validate``: a fresh Learner's validation metrics. ``resume``: one
    epoch in two parts (a stop requested on the last rank after the first
    batch, then a resumed Learner finishing the epoch) → the state, the
    log rows and the resume position."""
    from zsgnet_tpu_torch.data.dataset import get_data
    from zsgnet_tpu_torch.train.learner import Learner

    cfg = learner_cfg(case, root, tmp)
    data = get_data(cfg, shard_id=rank, num_shards=world)
    learn = Learner(case, data, cfg, device="cpu")
    if case == "validate":
        return {"metrics": learn.validate(), "mesh": learn.mesh is not None}
    if rank == world - 1:
        learn.request_stop()
    learn.fit(1)
    stopped_at = learn.state.step
    resumed = Learner(case, get_data(cfg, shard_id=rank, num_shards=world), cfg.replace(resume=True),
                      device="cpu")
    position = (resumed.epoch, resumed._resume_batches, resumed.state.step)
    resumed.fit(1)
    return {"stopped_at": stopped_at, "position": position, "step": resumed.state.step,
            "state": resumed.model.state_dict(), "metrics": resumed.validate()}


def run(rank: int, world: int, store: str, init: str, root: str, tmp: str, out: str) -> None:
    """One rank: join the group, run every case, write the results."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    from zsgnet_tpu_torch.parallel.mesh import init_distributed

    mesh = init_distributed("cpu", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        sd = torch.load(init, weights_only=True)
        for case in STEP_CASES:
            cfg = step_cfg(case)
            res = run_steps(cfg, sd, global_batches(cfg), mesh)
            if rank:  # rank 0's state is the one compared; the others' must be its bytes
                res["state"] = fingerprint(res["state"])
            torch.save(res, f"{out}/{case}_rank{rank}.pt")
        for case in LEARNER_CASES:
            torch.save(run_learner(case, root, tmp, rank, world), f"{out}/{case}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()
