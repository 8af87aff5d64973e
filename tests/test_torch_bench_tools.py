"""The port's measurement tools (``zsgnet_tpu_torch/tools/``: ``profile_bench``,
``bench_infer_ab``, ``bench_grouped_train``, ``profile_train_step``) on the
CPU at a small size (64², widths 16 and 8, float32, B = 2): each
returns its dict with positive figures, draws its batch in the JAX tool's
order, and ``profile_train_step``'s categorizer sorts kernel names as the
card names them. The tools write no file."""

import numpy as np
import pytest
import torch

from _torch_port import cfg_pair
from zsgnet_tpu_torch import bench as headline
from zsgnet_tpu_torch.tools import bench_grouped_train, bench_infer_ab, profile_bench, profile_train_step

torch.set_num_threads(1)

VOCAB = headline.VOCAB
CPU = dict(device="cpu")


def _cfg():
    return cfg_pair(max_qlen=12)[1]


def test_profile_bench_returns_its_three_timings():
    res = profile_bench.bench(2, cfg=_cfg(), warmup=1, iters=1, **CPU)
    assert set(res) == {"fwd_only", "fwd_decode", "fwd_full_eval"}
    assert all(r["ms"] > 0 and r["qps"] > 0 for r in res.values())


def test_bench_infer_ab_canvas_equals_per_level_in_float32(monkeypatch):
    seen = []
    monkeypatch.setattr(bench_infer_ab, "to_device", lambda b, d: seen.append(b) or headline.to_device(b, d))
    res = bench_infer_ab.bench(2, cfg=_cfg(), warmup=1, iters=1, **CPU)
    assert list(res) == ["per-level", "canvas", "int8"]
    assert all(r["ms"] > 0 and r["qps"] > 0 and np.isfinite(r["checksum"]) for r in res.values())
    assert abs(res["canvas"]["checksum"] - res["per-level"]["checksum"]) < 1e-4
    rng = np.random.default_rng(0)  # tools/bench_infer_ab.py:27-31: bench.py's draw
    want = [rng.integers(0, 255, size=(2, 64, 64, 3)).astype(np.uint8),
            rng.integers(1, VOCAB, size=(2, 12)).astype(np.int32), rng.integers(3, 12, size=(2,)).astype(np.int32)]
    for k, w in zip(("img", "qvec", "qlens"), want):
        assert seen[0][k].tobytes() == w.tobytes()


def test_bench_grouped_train_runs_flat_grouped_and_masked(monkeypatch):
    seen = []
    monkeypatch.setattr(bench_grouped_train, "host_batch",
                        lambda b, d: seen.append(b) or {k: torch.from_numpy(v) for k, v in b.items()})
    res = bench_grouped_train.bench(10, 5, cfg=_cfg(), warmup=1, iters=1, **CPU)
    for k in ("flat", "grouped", "grouped_masked"):
        assert res[k]["ms"] > 0 and res[k]["pairs_per_s"] > 0 and np.isfinite(res[k]["loss"])
    assert res["speedup"] > 0 and res["speedup_masked"] > 0
    rng = np.random.default_rng(0)  # tools/bench_grouped_train.py:47-73, one generator over the three runs
    for got, grouped in zip(seen, (False, True, True)):
        qshape = (2, 5) if grouped else (10,)
        gt = np.stack([rng.uniform(-1, -0.1, qshape), rng.uniform(-1, -0.1, qshape),
                       rng.uniform(0.1, 1, qshape), rng.uniform(0.1, 1, qshape)], axis=-1).astype(np.float32)
        want = {"annot": gt, "img": rng.integers(0, 255, size=(qshape[0], 64, 64, 3)).astype(np.uint8),
                "qvec": rng.integers(1, VOCAB, size=qshape + (12,)).astype(np.int32),
                "qlens": rng.integers(3, 12, size=qshape).astype(np.int32)}
        for k, w in want.items():
            assert got[k].tobytes() == w.tobytes(), k
    assert "pair_valid" not in seen[0] and seen[1]["pair_valid"].all()
    assert seen[2]["pair_valid"].sum() == 9 and not seen[2]["pair_valid"][0, -1]  # :80-84


@pytest.mark.parametrize("mode", ["train", "infer", "remat_accum"])
def test_profile_train_step_returns_wall_and_qps(mode):
    kw = {"train": {}, "infer": dict(infer_only=True, canvas=True), "remat_accum": dict(remat=True, grad_accum=2)}
    res = profile_train_step.bench(2, cfg=_cfg(), resize=64, steps=1, **kw[mode], **CPU)
    assert res["wall_ms"] > 0 and res["qps"] > 0 and res["peak_bytes"] is None  # no card: no trace


def test_profile_train_step_batch_is_the_jax_tools_draw():
    rng = np.random.default_rng(0)  # tools/profile_train_step.py:63-72
    img = rng.integers(0, 255, size=(3, 64, 64, 3)).astype(np.uint8)
    qvec = rng.integers(1, VOCAB, size=(3, 12)).astype(np.int32)
    qlens = rng.integers(3, 12, size=(3,)).astype(np.int32)
    annot = np.stack([rng.uniform(-0.9, -0.1, size=(3, 2)), rng.uniform(0.1, 0.9, size=(3, 2))],
                     axis=1).reshape(3, 4).astype(np.float32)
    got = profile_train_step.train_batch(np.random.default_rng(0), _cfg(), 3)
    for k, w in (("img", img), ("qvec", qvec), ("qlens", qlens), ("annot", annot)):
        assert got[k].tobytes() == w.tobytes(), k


KERNELS = {
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64": "conv forward",
    "implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3, 1, false, false, true>": "conv forward",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64": "conv dgrad",
    "void cudnn::detail::dgrad_engine<float, 128, 6, 7, 3, 3, 5, false>": "conv dgrad",
    "sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64": "conv wgrad",
    "void cudnn::detail::wgrad_alg0_engine<float, 128, 6, 8, 3, 3, 5, false, 512>": "conv wgrad",
    "void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, 1, true>": "batchnorm forward",
    "void at::native::batch_norm_collect_statistics_kernel<at::native::InvStd, float, float, float, int>":
        "batchnorm forward",
    "void cudnn::bn_bw_1C11_kernel_new<float, float, float2, 512, true, 1>": "batchnorm backward",
    "void at::native::batch_norm_backward_reduce_kernel<float, float, float, int>": "batchnorm backward",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true>":
        "layout copy",
    "void cudnn::engines_precompiled::nhwcToNchwKernel<float, __nv_bfloat16, float, true, false>": "layout copy",
    "void elemWiseRNNcell<float, float, float, (cudnnRNNMode_t)2, (cudnnRNNBiasMode_t)2>": "lstm",
    "RNN_blockPersist_fp_LSTM<float, float, float, 256, true>": "lstm",
    "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128_nn_align1>(cutlass_75_tensorop_bf16_"
    "s1688gemm_bf16_128x128_nn_align1::Params)": "conv as GEMM",
    "void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_256x64_32x4_nhwc_align8>":
        "conv forward",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x128x64": "conv wgrad",
    "void at::native::(anonymous namespace)::max_pool_backward_nchw<c10::BFloat16, float, int>": "other",
    "match_loss_row_cluster": "loss K1",
    "match_loss_grads_pos_only": "loss K2",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)::"
    "TensorListMetadata<4>, FusedAdamMathFunctor<float, 4>>": "optimizer",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>": "other",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::MaxOps<float>>>": "other",
}


def test_categorizer_places_kernel_names():
    assert {k: profile_train_step.category(k) for k in KERNELS} == KERNELS
    agg = profile_train_step.by_category([(k, 1.0) for k in KERNELS])
    assert agg["conv forward"] == 3.0 and agg["other"] == 3.0 and agg["loss K1"] == 1.0
    assert sum(agg.values()) == len(KERNELS) and list(agg.values()) == sorted(agg.values(), reverse=True)


def test_profile_train_step_refuses_the_tpu_only_flags():
    for flag in ("--vmem=4096", "--bnfast", "--bnshift", "--bnshift16"):
        with pytest.raises(SystemExit, match="TPU-only"):
            profile_train_step.main(["8", flag])
