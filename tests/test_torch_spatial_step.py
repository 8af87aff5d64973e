"""The port's spatial train step and evaluation under the (data 2,
spatial 2) mesh on the CPU, held against one process and the JAX halo
step under ``shard_map``.

One cluster launch: four gloo ranks (``torch.multiprocessing``, a
``FileStore``) run ``tests/_torch_sp_worker.py::run_steps`` while this
process computes the references; the cluster has a deadline and the test
fails when it passes. 64², ResNet-50 + FPN 16, head 16, float32, lr 1e-6
(tests/test_torch_multihost.py says why).

* The train step, 2 steps of a global batch: the fused focal path under SGD
  (B = 4: each rank holds one sample after the reshard), and under Adam
  with ``grad_accum=2``, grouped Q = 2 and ``remat_backbone`` (B = 8 images,
  16 pairs: each micro-batch of a data index's 4 images splits 2 and 2 over
  its members). The four ranks end bit-equal. Against one process on the
  same global batches (under ``grad_accum`` micro-batch i is every data
  index's i-th local micro-batch, as in JAX): the loss dict within rtol
  1e-4 with ``num_pos`` exact, BatchNorm statistics within atol 1e-3 and
  the updates (p − p0) within relative L2 0.02 under SGD and 0.25 under
  Adam, tests/test_torch_multihost.py's budgets for the same float32
  reordering. Against the JAX halo step on a (2, 2) slice of the virtual
  CPU mesh on the same weights: loss within 1e-3·2.5^i relative, updates
  within relative L2 0.25, BatchNorm statistics within atol 2e-2.
* SSD-VGG16 (no BatchNorm) under SGD, its VGG tower split by height: B = 4
  (two images a data index, one a member after the reshard), B = 2 (one
  image a data index: every member gathers it, runs the rest of the model
  and the loss on it, and weighs its copy 1/S), and grouped Q = 2 under
  ``grad_accum=2`` (each micro-batch gathered). The four ranks end
  bit-equal. Against one process on the same global batches: the loss dict
  within rtol 1e-5 with ``num_pos`` exact and the updates within relative
  L2 0.02. Against the JAX step on the same weights and batches,
  tests/test_spatial.py::test_spatial_train_step_exact_on_bn_free_ssd's
  bars (loss rtol 1e-5, ``num_pos`` exact, parameters rtol 1e-3 and atol
  5e-4) and the updates within relative L2 0.02, held against the JAX
  one-device step; against the JAX GSPMD step (``jax.jit`` with
  ``in_shardings`` on a (2, 2) slice of the virtual CPU mesh) ``num_pos``
  exact and the parameters within the same bars. The JAX GSPMD train step
  is not exact here: its first loss differs from its own one-device step's
  by up to 1.3e-4 relative and its updates by 15-21 % relative L2
  (measured at 64², 80² and 96² on a (2, 2) mesh, with and without the
  Pallas loss), while its forward-only evaluation equals the one-device
  one; the port equals the one-device step.
"""

import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp
from flax import traverse_util

import _torch_sp_worker as W
from _torch_mh_worker import fingerprint
from _torch_port import cfg_pair, jax_variables
from zsgnet_tpu.convert.torch_import import convert_zsgnet_checkpoint
from zsgnet_tpu.models.zsgnet import anchor_pyramid_for as j_anchor_pyramid
from zsgnet_tpu.models.zsgnet import get_default_net as j_net
from zsgnet_tpu.parallel import train_step as jts
from zsgnet_tpu.parallel.mesh import make_mesh as j_make_mesh
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.models.zsgnet import get_default_net

torch.set_num_threads(1)

HEAD = ("head.conv0", "head.conv1", "head.conv2", "head.conv3", "head.out")
DEADLINE_S = 300
SSD_CASES = [c for c, (kw, _) in W.STEP_CASES.items() if kw.get("mdl_to_use") == "ssd_vgg"]
RETINA_CASES = [c for c in W.STEP_CASES if c not in SSD_CASES]


class Cluster:
    def __init__(self, tmp):
        self.out = tmp / "out"
        self.out.mkdir()
        cfg = W.step_cfg("sgd")
        init = get_default_net(cfg, W.VOCAB, seed=1, device="cpu").state_dict()
        self.variables = jax.tree.map(np.asarray, convert_zsgnet_checkpoint(
            init, head_conv_prefixes=HEAD, num_anchors=cfg.num_anchors))
        self.init = state_dict_from_jax(self.variables, cfg)
        ssd_cfg = W.step_cfg(SSD_CASES[0])
        self.variables_ssd = jax_variables(cfg_pair(mdl_to_use="ssd_vgg")[0], W.VOCAB, seed=1)
        self.init_ssd = state_dict_from_jax(self.variables_ssd, ssd_cfg)
        torch.save({"retina": self.init, "ssd_vgg": self.init_ssd}, tmp / "init.pt")
        self.ctx = tmp_mp.start_processes(
            W.run_steps, args=(W.WORLD, str(tmp / "store"), str(tmp / "init.pt"), str(self.out)),
            nprocs=W.WORLD, join=False, start_method="spawn")
        self.done = False

    def wait(self) -> None:
        if self.done:
            return
        deadline = time.monotonic() + DEADLINE_S
        try:
            while not self.ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise AssertionError(f"the {W.WORLD}-process cluster did not finish in {DEADLINE_S} s")
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
    tmp = tmp_path_factory.mktemp("sp_steps")
    c = Cluster(tmp)
    yield c
    for p in c.ctx.processes:
        if p.is_alive():
            p.kill()
    shutil.rmtree(tmp, ignore_errors=True)


def _flat(state_dict, cfg) -> dict:
    conv = convert_zsgnet_checkpoint(dict(state_dict), head_conv_prefixes=HEAD, num_anchors=cfg.num_anchors)
    return {c: traverse_util.flatten_dict(jax.tree.map(np.asarray, conv[c])) for c in ("params", "batch_stats")}


def _update_rel_l2(got: dict, want: dict, p0: dict) -> float:
    d_want = np.concatenate([(want[k] - p0[k]).ravel() for k in want])
    d_got = np.concatenate([(got[k] - p0[k]).ravel() for k in want])
    return float(np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want))


def _jax_mesh_steps(case: str, variables: dict, batches: list[dict], spatial: bool = True) -> dict:
    """The JAX step on a (2, 2) mesh: the halo step for retina, the GSPMD
    step for SSD-VGG (``spatial_mode='auto'``); one device without
    ``spatial``."""
    jcfg, _ = cfg_pair(bs=W.STEP_CASES[case][1], lr=1e-6, **W.STEP_CASES[case][0])
    mesh = None
    if spatial:
        jcfg = jcfg.replace(do_dist=True, mesh_spatial=2)
        mesh = j_make_mesh(jcfg, jax.devices()[:4])
        assert mesh.devices.shape == (2, 2)
    tx = jts.make_optimizer(jcfg)
    state = jts.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"], batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]), lr_scale=jnp.ones((), jnp.float32), tx=tx,
        apply_fn=j_net(jcfg, vocab_size=W.VOCAB).apply,
    )
    step = jts.make_train_step(jcfg, j_anchor_pyramid(jcfg), mesh=mesh)
    keys = jts.train_batch_keys(jcfg)
    losses = []
    for b in batches:
        state, ls = step(state, {k: b[k] for k in keys})
        losses.append({k: float(v) for k, v in ls.items()})
    flat = lambda t: traverse_util.flatten_dict(jax.tree.map(np.asarray, t))  # noqa: E731
    return {"losses": losses, "params": flat(state.params), "batch_stats": flat(state.batch_stats),
            "variables": {"params": jax.tree.map(np.asarray, state.params)}}


def _one_process(case: str, init: dict) -> dict:
    cfg = W.step_cfg(case)
    batches = W.global_batches(cfg)
    if cfg.grad_accum > 1:  # micro-batch i = every data index's i-th local micro-batch
        b, k, d = cfg.bs, cfg.grad_accum, 2
        m = b // d // k
        order = [dd * (b // d) + i * m + j for i in range(k) for dd in range(d) for j in range(m)]
        batches = [{key: v[order] for key, v in bt.items()} for bt in batches]
    return W.run_train_steps(cfg, init, batches)


@pytest.mark.parametrize("case", RETINA_CASES)
def test_spatial_step_as_one_process_and_as_jax_halo(cluster, case):
    cfg = W.step_cfg(case)
    want_jax = _jax_mesh_steps(case, cluster.variables, W.global_batches(cfg))
    one = _one_process(case, cluster.init)
    ranks = [cluster.result(case, r) for r in range(W.WORLD)]
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"]
        assert r["state"] == fingerprint(r0["state"])
    p0 = _flat(cluster.init, cfg)["params"]
    sp, ref = _flat(r0["state"], cfg), _flat(one["state"], cfg)
    for i, (got, want, jwant) in enumerate(zip(r0["losses"], one["losses"], want_jax["losses"])):
        assert got["num_pos"] == want["num_pos"] == jwant["num_pos"], i
        for k in ("total", "cls_ls", "box_ls"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {i} {k}")
        assert abs(got["total"] - jwant["total"]) / abs(jwant["total"]) <= 1e-3 * 2.5 ** i, (i, got, jwant)
    assert _update_rel_l2(sp["params"], ref["params"], p0) <= (0.02 if cfg.opt_to_use == "sgd" else 0.25)
    assert _update_rel_l2(sp["params"], want_jax["params"], p0) <= 0.25
    assert set(sp["batch_stats"]) == set(want_jax["batch_stats"])
    for k, v in sp["batch_stats"].items():
        np.testing.assert_allclose(v, ref["batch_stats"][k], atol=1e-3, rtol=0, err_msg=str(k))
        np.testing.assert_allclose(v, want_jax["batch_stats"][k], atol=2e-2, rtol=0, err_msg=str(k))


def _update_rel_l2_sd(got: dict, want: dict, p0: dict) -> float:
    d_want = torch.cat([(want[k].double() - p0[k].double()).ravel() for k in p0])
    d_got = torch.cat([(got[k].double() - p0[k].double()).ravel() for k in p0])
    return float((d_got - d_want).norm() / d_want.norm())


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_spatial_step_as_one_process_and_as_jax_gspmd(cluster, case):
    cfg = W.step_cfg(case)
    batches = W.global_batches(cfg)
    jax_one = _jax_mesh_steps(case, cluster.variables_ssd, batches, spatial=False)
    jax_gspmd = _jax_mesh_steps(case, cluster.variables_ssd, batches)
    one = _one_process(case, cluster.init_ssd)
    ranks = [cluster.result(case, r) for r in range(W.WORLD)]
    r0 = ranks[0]
    for r in ranks[1:]:
        assert r["losses"] == r0["losses"]
        assert r["state"] == fingerprint(r0["state"])
    for i, (got, want, j1, jg) in enumerate(zip(r0["losses"], one["losses"], jax_one["losses"],
                                                 jax_gspmd["losses"])):
        assert got["num_pos"] == want["num_pos"] == j1["num_pos"] == jg["num_pos"], i
        for k in ("total", "cls_ls", "box_ls"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(got["total"], j1["total"], rtol=1e-5, err_msg=f"step {i} vs JAX")
    p0 = cluster.init_ssd
    got = r0["state"]
    for ref in (jax_one, jax_gspmd):
        jax_sd = state_dict_from_jax(ref["variables"], cfg)
        assert set(got) == set(jax_sd) == set(one["state"])
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), jax_sd[k].numpy(), rtol=1e-3, atol=5e-4, err_msg=k)
    assert _update_rel_l2_sd(got, one["state"], p0) <= 0.02
    assert _update_rel_l2_sd(got, state_dict_from_jax(jax_one["variables"], cfg), p0) <= 0.02
