"""The port's data parallel across two processes on the CPU, held against
one process and against the JAX ``shard_map`` step.

One cluster launch: two ranks (``torch.multiprocessing``, gloo, a
``FileStore``) run every case of ``tests/_torch_mh_worker.py`` while this
process computes the references; each child has a deadline and the test
fails when it passes. 64², ResNet-50 + FPN 16, head 16, float32, lr 1e-6
(at the default 1e-4 the trajectory at this size is chaotic:
tests/test_torch_train_step.py).

* The train step, 2 steps of a global batch of 4 (grouped: 4 images × 2
  phrases), each rank taking its half: the fused focal path (under SGD,
  whose update is the gradient itself), and under Adam ``grad_accum=2``, the
  eager softmax loss (``group`` reaching ``losses.zsg_loss``) and grouped
  Q = 2. The ranks end bit-equal to each other. Against one process on the
  same global batches: each step's loss dict within rtol 1e-4 (``num_pos``
  exact; measured ≤ 1.1e-5), the BatchNorm statistics within atol 1e-3
  (measured ≤ 2.9e-4), and the parameter updates (p − p0) within relative
  L2 0.02 under SGD (measured 7.1e-3) and 0.25 under Adam (measured
  ≤ 0.13): float32 sums in another order (two ranks' partial sums, the
  two-pass synchronized moments), which Adam's first step, lr·sign(g),
  turns into whole-step flips where a gradient is near 0.
  Against the JAX step under ``shard_map`` on a 2-device slice of the
  virtual CPU mesh (the same weights, through ``convert.state_dict_from_jax``),
  the budget of tests/test_torch_train_step.py: loss within 1e-3·2.5^i
  relative (measured ≤ 2.2e-5), updates within relative L2 0.25 (≤ 0.10;
  2.8e-2 under SGD),
  BatchNorm statistics atol 2e-2 (≤ 3.3e-4).
  Under ``grad_accum`` micro-batch i is every rank's i-th local micro-batch,
  as in JAX, so the one-process run takes the global batch with its rows in
  that order (ROADMAP.md queue 3).
* Validation through two Learners equals one Learner's summary: Acc, MaxPos
  and num_samples exactly, MeanIoU and loss within rtol 1e-5.
* Checkpoint and resume: a stop requested on rank 1 alone stops both ranks
  after the first batch; rank 0 writes the checkpoint; two resumed Learners
  continue mid-epoch as one process does (the same position, the
  parameters within atol 5e-6 — two Adam steps of lr 1e-6 — the BatchNorm
  statistics within atol 1e-3 and the metrics as above), and the log has
  one row.
"""

import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp
from flax import traverse_util

import _torch_mh_worker as W
from _torch_port import cfg_pair
from zsgnet_tpu.convert.torch_import import convert_zsgnet_checkpoint
from zsgnet_tpu.models.zsgnet import anchor_pyramid_for as j_anchor_pyramid
from zsgnet_tpu.models.zsgnet import get_default_net as j_net
from zsgnet_tpu.parallel import train_step as jts
from zsgnet_tpu.parallel.mesh import make_mesh as j_make_mesh
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.data import synthetic
from zsgnet_tpu_torch.models.zsgnet import get_default_net

torch.set_num_threads(1)

HEAD = ("head.conv0", "head.conv1", "head.conv2", "head.conv3", "head.out")
DEADLINE_S = 300


class Cluster:
    """The two ranks, started at once; ``result`` waits for them (once)."""

    def __init__(self, tmp):
        self.out = tmp / "out"
        self.out.mkdir()
        self.root = synthetic.generate(tmp / "data", n_train=8, n_val=10, n_test=4, img_size=64).parent
        self.tmp2 = tmp / "two"
        cfg = W.step_cfg("fused")
        init = get_default_net(cfg, W.VOCAB, seed=1, device="cpu").state_dict()
        self.variables = jax.tree.map(np.asarray, convert_zsgnet_checkpoint(
            init, head_conv_prefixes=HEAD, num_anchors=cfg.num_anchors))
        self.init = state_dict_from_jax(self.variables, cfg)
        torch.save(self.init, tmp / "init.pt")
        self.ctx = tmp_mp.start_processes(
            W.run, args=(2, str(tmp / "store"), str(tmp / "init.pt"), str(self.root), str(self.tmp2),
                         str(self.out)),
            nprocs=2, join=False, start_method="spawn")
        self.done = False

    def wait(self) -> None:
        if self.done:
            return
        deadline = time.monotonic() + DEADLINE_S
        try:
            while not self.ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"the 2-process cluster did not finish in {DEADLINE_S} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
        self.done = True

    def result(self, case: str, rank: int) -> dict:
        self.wait()
        return torch.load(self.out / f"{case}_rank{rank}.pt", weights_only=False)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mh")
    c = Cluster(tmp)
    yield c
    for p in c.ctx.processes:
        if p.is_alive():
            p.kill()
    shutil.rmtree(tmp, ignore_errors=True)  # ~2 GB of checkpoints and states


def _flat(state_dict, cfg) -> dict:
    conv = convert_zsgnet_checkpoint({k: v for k, v in state_dict.items()}, head_conv_prefixes=HEAD,
                                     num_anchors=cfg.num_anchors)
    return {c: traverse_util.flatten_dict(jax.tree.map(np.asarray, conv[c])) for c in ("params", "batch_stats")}


def _update_rel_l2(got: dict, want: dict, p0: dict) -> float:
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    return float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))


def _jax_steps(case: str, variables: dict, batches: list[dict]) -> dict:
    jcfg, _ = cfg_pair(bs=W.STEP_CASES[case][1], lr=1e-6, **W.STEP_CASES[case][0])
    mesh = j_make_mesh(jcfg.replace(mesh_shape=(2,)), jax.devices()[:2])
    tx = jts.make_optimizer(jcfg)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), lr_scale=jnp.ones((), jnp.float32), tx=tx,
        apply_fn=j_net(jcfg.replace(bn_sync_axis=jcfg.data_axis), vocab_size=W.VOCAB).apply,
    )
    step = jts.make_train_step(jcfg, j_anchor_pyramid(jcfg), mesh=mesh)
    keys = jts.train_batch_keys(jcfg)
    losses = []
    for b in batches:
        state, ls = step(state, {k: b[k] for k in keys})
        losses.append({k: float(v) for k, v in ls.items()})
    flat = lambda t: traverse_util.flatten_dict(jax.tree.map(np.asarray, t))  # noqa: E731
    return {"losses": losses, "params": flat(state.params), "batch_stats": flat(state.batch_stats)}


def _one_process(case: str, init: dict) -> dict:
    cfg = W.step_cfg(case)
    batches = W.global_batches(cfg)
    if cfg.grad_accum > 1:  # micro-batch i = every rank's i-th local micro-batch
        order = [0, 2, 1, 3]
        batches = [{k: v[order] for k, v in b.items()} for b in batches]
    return W.run_steps(cfg, init, batches)


@pytest.mark.parametrize("case", list(W.STEP_CASES))
def test_two_ranks_step_as_one_process_and_as_jax_shard_map(cluster, case):
    cfg = W.step_cfg(case)
    want_jax = _jax_steps(case, cluster.variables, W.global_batches(cfg))
    one = _one_process(case, cluster.init)
    r0, r1 = cluster.result(case, 0), cluster.result(case, 1)

    assert r0["losses"] == r1["losses"]
    assert W.fingerprint(r0["state"]) == r1["state"]
    p0 = _flat(cluster.init, cfg)["params"]
    two, ref = _flat(r0["state"], cfg), _flat(one["state"], cfg)
    for i, (got, want, jwant) in enumerate(zip(r0["losses"], one["losses"], want_jax["losses"])):
        assert got["num_pos"] == want["num_pos"] == jwant["num_pos"], i
        for k in ("total", "cls_ls", "box_ls"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {i} {k}")
        assert abs(got["total"] - jwant["total"]) / abs(jwant["total"]) <= 1e-3 * 2.5 ** i, (i, got, jwant)
    # SGD's update is lr·g: the gradients themselves (a mean where a sum is
    # due would be 0.5 off); Adam's first steps are lr·sign(g).
    assert _update_rel_l2(two["params"], ref["params"], p0) <= (0.02 if cfg.opt_to_use == "sgd" else 0.25)
    assert _update_rel_l2(two["params"], want_jax["params"], p0) <= 0.25
    assert set(two["batch_stats"]) == set(want_jax["batch_stats"])
    for k, v in two["batch_stats"].items():
        np.testing.assert_allclose(v, ref["batch_stats"][k], atol=1e-3, rtol=0, err_msg=str(k))
        np.testing.assert_allclose(v, want_jax["batch_stats"][k], atol=2e-2, rtol=0, err_msg=str(k))


def _same_metrics(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in ("Acc", "MaxPos", "num_samples"):
        assert got[k] == want[k], k
    for k in ("MeanIoU", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_gathered_validation_equals_one_process(cluster, tmp_path):
    want = W.run_learner("validate", str(cluster.root), str(tmp_path))
    assert not want["mesh"]
    for r in (0, 1):
        got = cluster.result("validate", r)
        assert got["mesh"]
        _same_metrics(got["metrics"], want["metrics"])
    assert want["metrics"]["num_samples"] == 10


def test_two_process_stop_and_resume_continue_as_one_process(cluster, tmp_path):
    want = W.run_learner("resume", str(cluster.root), str(tmp_path))
    shutil.rmtree(tmp_path / "models")  # ~0.8 GB of checkpoints
    got = [cluster.result("resume", r) for r in (0, 1)]
    for g in got:
        assert g["stopped_at"] == want["stopped_at"] == 1
        assert g["position"] == want["position"] == (0, 1, 1)
        assert g["step"] == want["step"] == 2
        _same_metrics(g["metrics"], want["metrics"])
        for k, v in want["state"].items():
            atol = 1e-3 if "running_" in k else 5e-6
            np.testing.assert_allclose(g["state"][k].numpy(), v.numpy(), atol=atol, rtol=0, err_msg=k)
    rows = (cluster.tmp2 / "logs" / "resume.jsonl").read_text().splitlines()
    assert len(rows) == 1
    models = cluster.tmp2 / "models" / "resume"
    assert sorted(p.name for p in models.glob("step_*.pt")) == ["step_1.pt", "step_2.pt"]
    assert not [p for p in models.rglob("*.tmp")] and not os.path.exists(cluster.tmp2 / "logs" / "tb")
