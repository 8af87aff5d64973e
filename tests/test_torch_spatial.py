"""The port's spatial partitioning across four processes on the CPU: the
height-sharded backbone's gradients, held against one process and against
the JAX halo backbone under ``shard_map``, and the refusals that need a
process group.

One cluster launch: four gloo ranks (``torch.multiprocessing``, a
``FileStore``) run ``tests/_torch_sp_worker.py::run_grads`` while this
process computes the references; the cluster has a deadline and the test
fails when it passes.

* In float64 and train mode (BatchNorm moments over every rank), the
  gradients of Σ p² over the FPN outputs (ResNet-50 + FPN 16, B = 4), summed
  over the ranks, equal the one-process gradients within 1e-9 relative per
  leaf: at S = 4 on 64×32 (world = one spatial group; layer4 reshards and
  the FPN meets mixed flags) and at S = 2 on 64² under the (2, 2) mesh
  (everything sharded through C5; the FPN's P6 reshards). Half of the
  stem's channels carry a BatchNorm bias of -3, so most of their maxpool
  windows are post-ReLU zeros that tie. The S = 4 gradients also equal the
  JAX halo ``ResNet50`` + ``FPN`` under ``shard_map`` on a (1, 4) slice of the
  virtual CPU mesh, on the same weights, within 1e-9 (the JAX package's own
  bar, ``tests/test_spatial.py::test_halo_backbone_grads_exact_fp64``).
* Validation through a Learner on the (data 2, spatial 2) mesh, under the
  JAX ``spatial_mode='gspmd'`` (evaluation runs; only touching the Learner's
  ``train_step`` raises, as in JAX), equals one Learner's summary (Acc, MaxPos and num_samples exactly, MeanIoU and loss
  within rtol 1e-5) and the JAX Learner's on its (4, 2) spatial mesh, on the
  same weights (Acc, MaxPos and num_samples exactly, MeanIoU and loss within
  rtol 1e-4: two frameworks' float32).
* SSD-VGG16 split by height (the port's counterpart of the JAX ``gspmd``
  mode), in float64 with Σ p² over its six maps: at S = 4 on 64×32 with
  two images (the batch does not divide over the members: every member
  gathers at conv6, ``vgg.31``, and weighs its copy 1/S; the gather's
  reduce-scatter backward gives the convolutions before it their
  gradients) and at S = 2 on 80² under the (2, 2) mesh (pool4, ``vgg.23``,
  reshards; the conv4_3 tap is resharded on its own). The gradients equal
  one process and the JAX ``SSDVGG16`` under ``jax.jit`` with the height
  sharded (``in_shardings``, GSPMD), within 1e-9 relative per leaf.
* Validation at one sample per data index (global B = 2 on the (2, 2)
  mesh: every spatial group gathers, member 0 reports the rows), retina and
  SSD-VGG, equals one Learner (Acc, MaxPos and num_samples exactly, MeanIoU
  and loss within rtol 1e-4) and the JAX Learner's GSPMD evaluation on a
  (2, 2) mesh, on the same weights (Acc, MaxPos and num_samples exactly,
  MeanIoU within atol 1e-4, loss within rtol 1e-4).
* The JAX refusals: retina training at a per-member batch below S, a
  micro-batch that does not divide over the members, SSD-VGG under
  ``spatial_mode='halo'``, a mesh larger than the world, S not dividing the
  world.
"""

import shutil
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp_mp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_sp_worker as W
from _torch_port import cfg_pair, jax_variables
from jax.sharding import NamedSharding

from zsgnet_tpu.models.fpn import FPN as JFPN
from zsgnet_tpu.models.resnet import ResNet50 as JResNet50
from zsgnet_tpu.models import ssd_vgg as j_ssd_vgg
from zsgnet_tpu.models.ssd_vgg import SSDVGG16 as JSSDVGG16
from zsgnet_tpu.parallel.halo import SpatialCtx as JSpatialCtx
from zsgnet_tpu.convert.torch_import import convert_zsgnet_checkpoint
from zsgnet_tpu.data.dataset import get_data as j_get_data
from zsgnet_tpu.train.learner import Learner as JLearner
from zsgnet_tpu_torch import convert
from zsgnet_tpu_torch.convert import state_dict_from_jax
from zsgnet_tpu_torch.config import Config
from zsgnet_tpu_torch.data import synthetic
from zsgnet_tpu_torch.data.dataset import get_data

torch.set_num_threads(1)
DEADLINE_S = 300
REL = 1e-9
HEAD = ("head.conv0", "head.conv1", "head.conv2", "head.conv3", "head.out")


class Cluster:
    def __init__(self, tmp):
        self.out = tmp / "out"
        self.out.mkdir()
        jcfg, self.tcfg = cfg_pair()
        variables = jax_variables(jcfg, W.VOCAB, seed=2)
        variables["params"]["backbone"]["bn1"]["bias"][:32] = -3.0  # post-ReLU zeros, tied maxima
        self.variables = variables
        self.sd = state_dict_from_jax(variables, self.tcfg)
        jcfg_ssd, tcfg_ssd = cfg_pair(mdl_to_use="ssd_vgg")
        self.variables_ssd = jax_variables(jcfg_ssd, W.VOCAB, seed=2)
        self.root = synthetic.generate(tmp / "data", n_train=8, n_val=10, n_test=4, img_size=64).parent
        # The validation Learners' weights at the dataset's vocabulary.
        n_vocab = len(get_data(Config(**W.TINY, data_dir=str(self.root), tmp_path=str(tmp))).vocab)
        self.tiny = {}
        inits = {"retina": self.sd, "ssd_vgg": state_dict_from_jax(self.variables_ssd, tcfg_ssd)}
        for mdl in W.VALIDATE_B2:
            jc, tc = cfg_pair(mdl_to_use=mdl)
            self.tiny[mdl] = jax_variables(jc, n_vocab, seed=4)
            inits[f"{mdl}_tiny"] = state_dict_from_jax(self.tiny[mdl], tc)
        torch.save(inits, tmp / "init.pt")
        self.ctx = tmp_mp.start_processes(
            W.run_grads, args=(W.WORLD, str(tmp / "store"), str(tmp / "init.pt"), str(self.root),
                               str(tmp / "four"), str(self.out)),
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

    def result(self, name: str, rank: int):
        self.wait()
        return torch.load(self.out / f"{name}_rank{rank}.pt", weights_only=False)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_grads")
    c = Cluster(tmp)
    yield c
    for p in c.ctx.processes:
        if p.is_alive():
            p.kill()
    shutil.rmtree(tmp, ignore_errors=True)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / (b.norm() + 1e-300))


def _jax_halo_grads(variables: dict, x_nchw: np.ndarray, s: int) -> dict:
    """The JAX halo ResNet50 + FPN gradients of Σ p² under shard_map on a
    (1, s) mesh, in float64, as port parameter names."""
    mesh = Mesh(np.array(jax.devices()[:s]).reshape(1, s), ("data", "spatial"))
    ctx = JSpatialCtx("spatial", s)
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        params = f64({"backbone": variables["params"]["backbone"], "fpn": variables["params"]["fpn"]})
        stats = f64(variables["batch_stats"]["backbone"])
        bb = JResNet50(dtype=jnp.float64, bn_variance="exact", bn_axis=("data", "spatial"))
        fpn = JFPN(out_ch=16, dtype=jnp.float64)
        x = jnp.asarray(x_nchw.transpose(0, 2, 3, 1))

        def local(xl):
            def loss(p):
                (feats, flags), _ = bb.apply({"params": p["backbone"], "batch_stats": stats}, xl, True,
                                             spatial=ctx, mutable=["batch_stats"])
                outs = fpn.apply({"params": p["fpn"]}, feats, spatial=ctx, shard_flags=flags)
                return sum(jnp.sum(o ** 2) for o in outs)

            return jax.tree.map(lambda t: lax.psum(t, ("data", "spatial")), jax.grad(loss)(params))

        g = jax.jit(shard_map(local, mesh=mesh, in_specs=P(None, "spatial"), out_specs=P(),
                              check_vma=False))(x)
        g = jax.tree.map(np.asarray, g)
    # The converter's own mapping (transposes only), kept in float64.
    sd: dict = {}
    with mock.patch.object(convert, "_t", lambda a: torch.from_numpy(np.array(a, dtype=np.float64))):
        convert._resnet_fpn(sd, g, {"backbone": variables["batch_stats"]["backbone"]})
    return {k.replace("backbone.", "", 1): v for k, v in sd.items()
            if "running_" not in k and "num_batches" not in k}


class _Float64Jnp:
    """``jax.numpy`` whose ``float32`` is float64: the JAX ``L2Norm``'s
    float32 island in float64, as the port's ``L2Norm`` computes a float64
    input."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_gspmd_ssd_grads(variables: dict, x_nchw: np.ndarray, s: int) -> dict:
    """The JAX ``SSDVGG16`` gradients of Σ p² over its six maps under
    ``jax.jit`` with the image height sharded over a (W/s, s) mesh (GSPMD),
    in float64 (its ``L2Norm`` too), as port parameter names."""
    mesh = Mesh(np.array(jax.devices()[:W.WORLD]).reshape(W.WORLD // s, s), ("data", "spatial"))
    with jax.enable_x64(True), mock.patch.object(j_ssd_vgg, "jnp", _Float64Jnp()):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"]["backbone"])
        vgg = JSSDVGG16(dtype=jnp.float64)

        def loss(p, x):
            return sum(jnp.sum(o ** 2) for o in vgg.apply({"params": p}, x))

        g = jax.jit(jax.grad(loss), in_shardings=(NamedSharding(mesh, P()),
                                                   NamedSharding(mesh, P("data", "spatial"))))(
            params, jnp.asarray(x_nchw.transpose(0, 2, 3, 1)))
        g = jax.tree.map(np.asarray, g)
    with mock.patch.object(convert, "_t", lambda a: torch.from_numpy(np.array(a, dtype=np.float64))):
        sd = convert.ssd_backbone_from_jax(g, prefix="")
    return sd


@pytest.mark.parametrize("case", list(W.GRAD_CASES))
def test_height_sharded_backbone_grads_equal_one_process_fp64(cluster, case):
    mdl, s, hw, b = W.GRAD_CASES[case]
    x = W.grad_input(hw, b)
    sd = cluster.sd if mdl == "retina" else state_dict_from_jax(cluster.variables_ssd, cfg_pair(mdl_to_use=mdl)[1])
    want, want_loss, _ = W.backbone_grads(sd, 16, x, mdl=mdl)
    r0 = cluster.result(case, 0)
    losses = [cluster.result(case, r)["loss"] for r in range(W.WORLD)]
    assert abs(sum(losses) - want_loss) <= REL * want_loss
    assert r0["mesh"] == (W.WORLD // s, s, 0, 0)
    landed = {"s4_64x32": {"layer4.0", "fpn.lat4", "fpn.lat3"},
              "s2_64x64": {"fpn.p6", "fpn.out3", "fpn.out4", "fpn.out5"},
              "ssd_s4_64x32_gathered": {"conv4_3": (2, 512, 2, 4), "vgg.31": (2, 512, 1, 2)},
              "ssd_s2_80x80": {"conv4_3": (2, 512, 5, 10), "vgg.23": (2, 512, 5, 10)}}[case]
    assert (set(r0["landed"]) if isinstance(landed, set) else r0["landed"]) == landed, r0["landed"]
    got = r0["grads"]
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) < REL, (k, _rel(got[k], want[k]))
    if mdl == "ssd_vgg":
        jax_g = _jax_gspmd_ssd_grads(cluster.variables_ssd, x, s)
        assert set(jax_g) == set(want)
        for k in want:
            assert _rel(got[k], jax_g[k]) < REL, (k, _rel(got[k], jax_g[k]))
    elif s == 4:
        jax_g = _jax_halo_grads(cluster.variables, x, s)
        assert set(jax_g) == set(want)
        for k in want:
            assert _rel(got[k], jax_g[k]) < REL, (k, _rel(got[k], jax_g[k]))


def test_spatial_refusals_keep_the_jax_words(cluster):
    for r in range(W.WORLD):
        e = cluster.result("errors", r)
        for name in ("micro_batch", "below_s"):
            assert e[name] == ("ValueError: spatial reshard needs the per-member batch 1 divisible by "
                               "mesh_spatial=2 (raise cfg.bs or lower mesh_spatial)"), name
        assert e["ssd_halo"] == ("NotImplementedError: halo spatial partitioning is retina-only; ssd_vgg uses "
                                 "the (measured-exact) GSPMD path")
        assert e["oversubscribed"] == "ValueError: mesh (data=4, spatial=2) needs 8 devices, have 4"
        assert e["indivisible"].startswith("ValueError: mesh_spatial=3 does not divide the 4 devices")


def _jax_validate(root, tmp, state_dict) -> dict:
    jcfg, _ = cfg_pair(**{k: v for k, v in W.TINY.items() if k not in ("ds_to_use",)},
                       ds_to_use="synthetic", data_dir=str(root), tmp_path=str(tmp), do_dist=True, mesh_spatial=2)
    learn = JLearner("sp_validate_jax", j_get_data(jcfg), jcfg)
    assert learn.mesh.devices.shape == (4, 2)
    v = jax.tree.map(jnp.asarray, convert_zsgnet_checkpoint(dict(state_dict), head_conv_prefixes=HEAD,
                                                             num_anchors=jcfg.num_anchors))
    learn.state = learn.state.replace(params=v["params"], batch_stats=v["batch_stats"])
    return learn.validate()


def test_spatial_validation_equals_one_process_and_jax(cluster, tmp_path):
    want = W.run_learner_validate(str(cluster.root), str(tmp_path / "one"))
    assert want["spatial"] is None and want["metrics"]["num_samples"] == 10
    got = [cluster.result("validate", r) for r in range(W.WORLD)]
    for g in got:
        assert g["spatial"] == 2
        assert g["train_step_error"].startswith("spatial_mode='gspmd' training is not supported for "
                                                "mdl_to_use='retina'")
        for k in ("Acc", "MaxPos", "num_samples"):
            assert g["metrics"][k] == want["metrics"][k], k
        for k in ("MeanIoU", "loss"):
            np.testing.assert_allclose(g["metrics"][k], want["metrics"][k], rtol=1e-5, err_msg=k)
    jwant = _jax_validate(cluster.root, tmp_path / "jax", want["state"])  # the Learners' seeded weights
    for k in ("Acc", "MaxPos", "num_samples"):
        assert got[0]["metrics"][k] == jwant[k], k
    for k in ("MeanIoU", "loss"):
        np.testing.assert_allclose(got[0]["metrics"][k], jwant[k], rtol=1e-4, err_msg=k)


def _jax_validate_variables(root, tmp, variables: dict, **kw) -> dict:
    """The JAX Learner's validation on a (data 2, spatial 2) mesh (GSPMD
    evaluation) with ``variables`` in its state."""
    jcfg, _ = cfg_pair(**{**W.TINY, "data_dir": str(root), "tmp_path": str(tmp), "do_dist": True,
                          "mesh_spatial": 2, "mesh_shape": (2,), **kw})
    learn = JLearner("sp_validate_jax", j_get_data(jcfg), jcfg)
    assert learn.mesh.devices.shape == (2, 2)
    v = jax.tree.map(jnp.asarray, variables)
    learn.state = learn.state.replace(params=v["params"], batch_stats=v.get("batch_stats", learn.state.batch_stats))
    return learn.validate()


@pytest.mark.parametrize("mdl", W.VALIDATE_B2)
def test_spatial_validation_at_one_sample_per_data_shard_equals_one_process_and_jax(cluster, tmp_path, mdl):
    """Global B = 2 on the (2, 2) mesh: each spatial group gathers its one
    sample, which its member 0 alone reports."""
    one = W.run_learner_validate(str(cluster.root), str(tmp_path / "one"), mdl_to_use=mdl, bs=2,
                                 state=state_dict_from_jax(cluster.tiny[mdl], cfg_pair(mdl_to_use=mdl)[1]))
    want = one["metrics"]
    assert want["num_samples"] == 10
    jwant = _jax_validate_variables(cluster.root, tmp_path / "jax", cluster.tiny[mdl], mdl_to_use=mdl, bs=2)
    for r in range(W.WORLD):
        g = cluster.result(f"validate_b2_{mdl}", r)
        assert g["spatial"] == 2 and g["train_step_error"] is None
        for ref in (want, jwant):
            for k in ("Acc", "MaxPos", "num_samples"):
                assert g["metrics"][k] == ref[k], (k, g["metrics"][k], ref[k])
            np.testing.assert_allclose(g["metrics"]["MeanIoU"], ref["MeanIoU"], atol=1e-4, rtol=0)
            np.testing.assert_allclose(g["metrics"]["loss"], ref["loss"], rtol=1e-4)
