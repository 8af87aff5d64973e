"""zsgnet_tpu_torch — ZSGNet evaluation and grounding in PyTorch on NVIDIA Hopper.

The PyTorch/CUDA counterpart of ``zsgnet_tpu``. Module paths mirror the JAX
package so each counterpart is easy to find; the JAX package is the
reference every module is tested against (``tests/test_torch_*.py``).

This package imports ``torch`` and never ``jax``, and nothing of
``zsgnet_tpu``: what it needs from that package's host-side modules
(config, vocab, synthetic data, the CSV dataset) it keeps as its own copy.

Entry points take ``device=`` and default to ``"cuda"``; without a CUDA
device they raise rather than fall back to the CPU. The one hand-written
kernel of this slice, the fused anchor match + focal + smooth-L1 loss
forward, lives in ``csrc/fused_loss.cu`` and is built with ``nvcc`` at first
use (``ops/cuda/build.py``). On CPU tensors its wrapper runs the plain
PyTorch version instead.
"""

__version__ = "0.1.0"

from zsgnet_tpu_torch.config import Config, get_default_cfg  # noqa: F401
