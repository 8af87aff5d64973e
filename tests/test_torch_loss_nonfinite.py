"""Non-finite logits and deltas through the port's fused loss on the CPU
(the plain versions of K1 and K2, through ``zsg_loss_fused`` and its
autograd Function) against the JAX package's ``zsg_loss_fused`` and
``jax.grad``, the Pallas kernels in interpret mode.

One case per value (NaN, +inf, -inf), input (a logit or a delta), anchor
label (positive by IoU, the promoted argmax, ignored, negative) and weight
of its row (1 or 0); ``zsgnet_tpu_torch.tools.loss_cases.nonfinite_case`` builds them and
the CUDA tests of K1 and K2 share them. The JAX kernel, as XLA compiles it,
turns a product with a 0/1 label into a select, so some non-finite inputs
give exact zeros and finite sums; the port gives the same. NaN positions
must be equal; the sums agree to rtol 2e-5 (float32 sums in another order,
the budget of tests/test_torch_ops.py) and the gradients to atol 1e-6.

Cases the plain versions got wrong before they followed the JAX kernel:
NaN in a delta at a positive or promoted anchor (dbbx 0, JAX NaN:
``torch.sign(NaN)`` is 0); any non-finite logit at an ignored anchor (the
class sum NaN and datt NaN, JAX finite and 0); and -inf at a negative
anchor, or +inf there with weight 1 (NaN, JAX 0 and a finite or infinite
class sum).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zsgnet_tpu.ops.pallas.fused_loss import pack_anchors as j_pack, zsg_loss_fused as j_fused
from zsgnet_tpu_torch.ops.cuda import fused_loss as fl
from zsgnet_tpu_torch.tools.loss_cases import NONFINITE_LABELS, nonfinite_case

torch.set_num_threads(1)

LAMB = 1.5
CASES = list(itertools.product(["nan", "inf", "-inf"], ["att", "bbx"], NONFINITE_LABELS, [1.0, 0.0]))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(anchors_key: bytes, gt_key: bytes):
    anchors = np.frombuffer(anchors_key, np.float32).reshape(-1, 4)
    gt = jnp.asarray(np.frombuffer(gt_key, np.float32).reshape(-1, 4))
    packed = jnp.asarray(j_pack(anchors))

    def total(att, bbx, w):
        out = j_fused(att, bbx, packed, gt, num_anchors=anchors.shape[0], lamb_reg=LAMB, sample_weight=w)
        return out["total"], out

    return jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))


@pytest.mark.parametrize("value,where,label,weight", CASES,
                         ids=[f"{v}-{x}-{lab}-w{int(wt)}" for v, x, lab, wt in CASES])
def test_nonfinite_inputs_match_jax(value, where, label, weight):
    c = nonfinite_case(float(value), where, label, weight)
    fn = _jax_loss_and_grad(c["anchors_cthw"].tobytes(), c["gt"].tobytes())
    with pltpu.force_tpu_interpret_mode():
        (_, want), (want_datt, want_dbbx) = fn(jnp.asarray(c["att"]), jnp.asarray(c["bbx"]), jnp.asarray(c["w"]))

    att = torch.from_numpy(c["att"]).requires_grad_()
    bbx = torch.from_numpy(c["bbx"]).requires_grad_()
    got = fl.zsg_loss_fused(att, bbx, fl.pack_anchors(c["anchors_cthw"], "cpu"), torch.from_numpy(c["gt"]),
                            lamb_reg=LAMB, sample_weight=torch.from_numpy(c["w"]))
    got["total"].backward()
    for k in ("cls_ls", "box_ls", "num_pos"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-5, equal_nan=True, err_msg=k)
    np.testing.assert_allclose(att.grad.numpy(), np.asarray(want_datt), atol=1e-6, rtol=0, equal_nan=True)
    np.testing.assert_allclose(bbx.grad.numpy(), np.asarray(want_dbbx), atol=1e-6, rtol=0, equal_nan=True)
    # The case reaches what it was built for: the anchor's own gradient
    # element is non-finite exactly where JAX's is.
    r, a = c["at"]
    elem = np.asarray(want_datt)[r, a] if where == "att" else np.asarray(want_dbbx)[r, a, 1]
    assert np.isfinite(elem) == np.isfinite(att.grad[r, a] if where == "att" else bbx.grad[r, a, 1]).item()
