// Fused anchor match + sigmoid focal + smooth-L1 loss: forward (kernel K1)
// and backward (kernel K2).
//
// K1 replaces the Pallas TPU kernel zsgnet_tpu/ops/pallas/fused_loss.py::_fwd_kernel
// (launched by _pallas_call_fwd). Same function, not a block-by-block copy:
// for every (row b, anchor a) it computes the IoU of the row's gt box with
// the anchor, the label (positive if IoU >= match_thr or a is the row's
// argmax-IoU anchor; ignored if neg_thr <= IoU < match_thr), the focal loss
// on non-ignored anchors, the variance-scaled regression targets and the
// smooth-L1 loss on positives, all times the row's sample weight, and sums
// (cls_sum, box_sum, num_pos) over the batch.
//
// Layout: att (B, A) f32, bbx (B, A, 4) f32 read as one float4 per anchor,
// anchors as two (A, 4) f32 arrays (tlbr and cthw, one float4 each), gt
// (B, 4) f32, w (B,) f32. There is no 512-lane padding and no batch-tile
// requirement: the grid's ragged edge is masked by index.
//
// Three launches on one stream over a (anchor chunk, row) grid:
// chunk_best_anchor finds each chunk's largest IoU; match_loss_partials
// merges a row's chunk candidates into the row's argmax-IoU anchor (the
// first of tied maxima, as jnp.argmax and torch.argmax; in the JAX package
// this prologue is XLA outside the Pallas kernel) and computes the loss
// partials; sum_partials adds them up. match_loss_partials also writes each
// row's argmax anchor to best_out, the residual K2 reads instead of
// searching again (the JAX VJP saves it in its aux array).
//
// K2 replaces fused_loss.py::_bwd_kernel (launched by _vjp_bwd). It is
// elementwise over a (anchor block, row) grid, one thread per anchor: it
// recomputes the IoU, labels and targets and writes
// datt = g_cls * focal'(x) * valid * w and dbbx = g_box * smoothL1'(d) * pos * w
// (closed forms of _focal_grad_tile and _smooth_l1_and_grad). Each thread
// loads one float4 each of bbx and both anchor arrays and stores one float4
// of dbbx; no atomics, no reduction, so it is deterministic. The upstream
// gradient (g_cls, g_box, g_num_pos) is read from device memory, so the
// backward never waits on the host. Bound: B*A*(4 + 16) bytes read and
// written each plus A*32 of anchors (11.7 MB at B = 16, A = 17451), 3.5 us
// at 3.35 TB/s; its arithmetic is a few dozen float operations per anchor.
//
// K1's bound: each input is read once and three floats are written, so the
// function moves B·A·20 + A·32 bytes (6.1 MB at B = 16, A = 17451): under
// 2 us at the H100's 3.35 TB/s (the argmax pass re-reads the 0.3 MB of
// tlbr anchors per row from L2). Per (row, anchor) it does a few dozen
// float operations and four transcendentals, far below the byte bound, so
// in practice launch latency and the bytes bound it. The design streams
// each input once with coalesced 16-byte loads and keeps every
// intermediate (IoU, labels, targets) in registers.
//
// Reduction: deterministic, no float atomics. The TPU kernel carries the
// sum across sequential grid steps; Hopper blocks run in no order, so each
// block of the (anchor chunk, row) grid reduces its threads' partials with
// warp shuffles and shared memory into partials[(row, chunk), 3], and a
// second one-block kernel sums the partials in a fixed order.
//
// Build: nvcc compiles this file's plain C interface into a shared library
// that zsgnet_tpu_torch/ops/cuda/build.py loads with ctypes. Compiled with -fmad=false so the IoU
// and target arithmetic rounds like the plain PyTorch version, which
// matters only at label thresholds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // anchors per block: 4 per thread
constexpr int kWarps = kThreads / 32;

struct LossParams {
  float match_thr, neg_thr, alpha, gamma, beta;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums v[0..2] over the block in a fixed order; thread 0 writes out[0..2].
__device__ __forceinline__ void block_sum3(float v0, float v1, float v2, float* out) {
  __shared__ float smem[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v0 = warp_sum(v0);
  v1 = warp_sum(v1);
  v2 = warp_sum(v2);
  if (lane == 0) {
    smem[0][warp] = v0;
    smem[1][warp] = v1;
    smem[2][warp] = v2;
  }
  __syncthreads();
  if (warp == 0) {
    float s0 = lane < kWarps ? smem[0][lane] : 0.f;
    float s1 = lane < kWarps ? smem[1][lane] : 0.f;
    float s2 = lane < kWarps ? smem[2][lane] : 0.f;
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      out[0] = s0;
      out[1] = s1;
      out[2] = s2;
    }
  }
}

// IoU of gt box g (area area_g) with anchor t, both tlbr, as
// ops/boxes.py::iou_pairwise computes it.
__device__ __forceinline__ float iou_tlbr(float4 g, float area_g, float4 t) {
  const float ity = fmaxf(g.x, t.x), itx = fmaxf(g.y, t.y);
  const float iby = fminf(g.z, t.z), ibx = fminf(g.w, t.w);
  const float inter = fmaxf(iby - ity, 0.f) * fmaxf(ibx - itx, 0.f);
  const float area_a = fmaxf(t.z - t.x, 0.f) * fmaxf(t.w - t.y, 0.f);
  const float uni = area_g + area_a - inter;
  return uni > 0.f ? inter / uni : 0.f;
}

__device__ __forceinline__ float area_tlbr(float4 g) {
  return fmaxf(g.z - g.x, 0.f) * fmaxf(g.w - g.y, 0.f);
}

// (value, index) argmax step: the larger value wins, the smaller index on ties.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block (chunk, row): the chunk's largest IoU and its first index, into
// cand_v/cand_i[row * n_chunks + chunk]. match_loss_partials merges a row's
// chunk candidates in chunk order, so the row's argmax is the first of ties.
__global__ void __launch_bounds__(kThreads) chunk_best_anchor(
    const float4* __restrict__ anc_tlbr, const float4* __restrict__ gt,
    float* __restrict__ cand_v, int* __restrict__ cand_i, int num_anchors) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const int row = blockIdx.y;
  const int chunk = blockIdx.x;
  const float4 g = gt[row];
  const float area_g = area_tlbr(g);
  const int end = min((chunk + 1) * kChunk, num_anchors);
  float v = -1.f;  // every IoU is >= 0, so a thread's first anchor is taken
  int i = num_anchors;
  for (int a = chunk * kChunk + threadIdx.x; a < end; a += kThreads) {
    const float iou = iou_tlbr(g, area_g, anc_tlbr[a]);
    if (iou > v) {  // strict: a thread sees its anchors in increasing order
      v = iou;
      i = a;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    argmax_merge(v, i, __shfl_down_sync(0xffffffffu, v, off), __shfl_down_sync(0xffffffffu, i, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sv[lane] : -1.f;
    i = lane < kWarps ? si[lane] : num_anchors;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(v, i, __shfl_down_sync(0xffffffffu, v, off), __shfl_down_sync(0xffffffffu, i, off));
    if (lane == 0) {
      cand_v[static_cast<size_t>(row) * gridDim.x + chunk] = v;
      cand_i[static_cast<size_t>(row) * gridDim.x + chunk] = i;
    }
  }
}

__device__ __forceinline__ float smooth_l1(float pred, float target, float beta) {
  const float d = fabsf(pred - target);
  return d < beta ? 0.5f * d * d / beta : d - 0.5f * beta;
}

// Variance-scaled regression targets (t_y, t_x, t_h, t_w) of gt box g at
// anchor c = (cy, cx, h, w), as ops/boxes.py::bbox_to_reg_params.
__device__ __forceinline__ float4 reg_targets(float4 g, float4 c) {
  const float g_cy = (g.x + g.z) * 0.5f;
  const float g_cx = (g.y + g.w) * 0.5f;
  const float g_h = g.z - g.x;
  const float g_w = g.w - g.y;
  const float a_h = fmaxf(c.z, 1e-8f);
  const float a_w = fmaxf(c.w, 1e-8f);
  return make_float4((g_cy - c.x) / (a_h * 0.1f), (g_cx - c.y) / (a_w * 0.1f),
                     logf(fmaxf(g_h / a_h, 1e-8f)) / 0.2f, logf(fmaxf(g_w / a_w, 1e-8f)) / 0.2f);
}

// d smooth_l1 / d pred: d / beta inside beta, sign(d) outside (sign(0) = 0).
__device__ __forceinline__ float smooth_l1_grad(float pred, float target, float beta) {
  const float d = pred - target;
  if (fabsf(d) < beta) return d / beta;
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
}

// d focal / d logit in closed form, as fused_loss.py::_focal_grad_tile:
// d p_t/dx = (2 pos - 1) p (1 - p), d bce/dx = p - pos.
__device__ __forceinline__ float focal_grad(float x, float pos, float alpha, float gamma) {
  const float prob = 1.f / (1.f + expf(-x));
  const float p_t = prob * pos + (1.f - prob) * (1.f - pos);
  const float alpha_t = alpha * pos + (1.f - alpha) * (1.f - pos);
  const float bce = fmaxf(x, 0.f) - x * pos + log1pf(expf(-fabsf(x)));
  const float one_m = 1.f - p_t;
  const float dpt = (2.f * pos - 1.f) * prob * (1.f - prob);
  return alpha_t * (-gamma * powf(one_m, gamma - 1.f) * dpt * bce + powf(one_m, gamma) * (prob - pos));
}

__global__ void __launch_bounds__(kThreads) match_loss_partials(
    const float* __restrict__ att, const float4* __restrict__ bbx,
    const float4* __restrict__ anc_tlbr, const float4* __restrict__ anc_cthw,
    const float4* __restrict__ gt, const float* __restrict__ cand_v,
    const int* __restrict__ cand_i, const float* __restrict__ weight,
    float* __restrict__ partials, int* __restrict__ best_out, int num_anchors, LossParams p) {
  const int row = blockIdx.y;
  const int chunk = blockIdx.x;
  const float4 g = gt[row];  // (ty, tx, by, bx)
  // The row's argmax-IoU anchor: the first chunk holding the maximum wins.
  const int n_chunks = static_cast<int>(gridDim.x);
  const size_t cand_off = static_cast<size_t>(row) * n_chunks;
  float best_v = cand_v[cand_off];
  int best = cand_i[cand_off];
  for (int c = 1; c < n_chunks; ++c) {
    if (cand_v[cand_off + c] > best_v) {
      best_v = cand_v[cand_off + c];
      best = cand_i[cand_off + c];
    }
  }
  if (chunk == 0 && threadIdx.x == 0) best_out[row] = best;
  const float w = weight[row];
  const float area_g = area_tlbr(g);

  const size_t row_off = static_cast<size_t>(row) * num_anchors;
  const int end = min((chunk + 1) * kChunk, num_anchors);
  float cls = 0.f, box = 0.f, npos = 0.f;
  for (int a = chunk * kChunk + threadIdx.x; a < end; a += kThreads) {
    const float4 t = anc_tlbr[a];
    const float4 c = anc_cthw[a];  // (cy, cx, h, w)
    const float x = att[row_off + a];
    const float4 d = bbx[row_off + a];

    const float iou = iou_tlbr(g, area_g, t);
    const bool is_pos = iou >= p.match_thr || a == best;
    const float pos = is_pos ? 1.f : 0.f;
    const float valid = (is_pos || iou < p.neg_thr) ? 1.f : 0.f;

    // Sigmoid focal loss, as ops/losses.py::sigmoid_focal_loss.
    const float bce = fmaxf(x, 0.f) - x * pos + log1pf(expf(-fabsf(x)));
    const float prob = 1.f / (1.f + expf(-x));
    const float p_t = prob * pos + (1.f - prob) * (1.f - pos);
    const float alpha_t = p.alpha * pos + (1.f - p.alpha) * (1.f - pos);
    const float focal = alpha_t * powf(1.f - p_t, p.gamma) * bce;
    cls += focal * valid * w;

    const float4 t4 = reg_targets(g, c);
    const float pos_w = pos * w;
    box += (smooth_l1(d.x, t4.x, p.beta) + smooth_l1(d.y, t4.y, p.beta) +
            smooth_l1(d.z, t4.z, p.beta) + smooth_l1(d.w, t4.w, p.beta)) *
           pos_w;
    npos += pos_w;
  }
  block_sum3(cls, box, npos, partials + (cand_off + chunk) * 3);
}

// K2. Block (anchor block, row), one thread per anchor. best_idx is K1's
// best_out; grad_out = (g_cls, g_box, g_num_pos) lives on the device.
__global__ void __launch_bounds__(kThreads) match_loss_grads(
    const float* __restrict__ att, const float4* __restrict__ bbx,
    const float4* __restrict__ anc_tlbr, const float4* __restrict__ anc_cthw,
    const float4* __restrict__ gt, const float* __restrict__ weight,
    const int* __restrict__ best_idx, const float* __restrict__ grad_out,
    float* __restrict__ datt, float4* __restrict__ dbbx, int num_anchors, LossParams p) {
  const int row = blockIdx.y;
  const int a = blockIdx.x * kThreads + threadIdx.x;
  if (a >= num_anchors) return;
  const float4 g = gt[row];
  const float w = weight[row];
  const float g_cls = grad_out[0];
  const float g_box = grad_out[1];
  const float4 t = anc_tlbr[a];
  const float4 c = anc_cthw[a];
  const size_t i = static_cast<size_t>(row) * num_anchors + a;
  const float x = att[i];
  const float4 d = bbx[i];

  const float iou = iou_tlbr(g, area_tlbr(g), t);
  const bool is_pos = iou >= p.match_thr || a == best_idx[row];
  const float pos = is_pos ? 1.f : 0.f;
  const float valid = (is_pos || iou < p.neg_thr) ? 1.f : 0.f;
  datt[i] = g_cls * focal_grad(x, pos, p.alpha, p.gamma) * valid * w;

  const float4 t4 = reg_targets(g, c);
  dbbx[i] = make_float4(g_box * smooth_l1_grad(d.x, t4.x, p.beta) * pos * w,
                        g_box * smooth_l1_grad(d.y, t4.y, p.beta) * pos * w,
                        g_box * smooth_l1_grad(d.z, t4.z, p.beta) * pos * w,
                        g_box * smooth_l1_grad(d.w, t4.w, p.beta) * pos * w);
}

// One block: out[k] = sum over n partial triples of partials[i, k], in a
// fixed order (thread i takes entries i, i + kThreads, ...; then the tree).
__global__ void __launch_bounds__(kThreads) sum_partials(const float* __restrict__ partials,
                                                         int n, float* __restrict__ out) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    s0 += partials[3 * i];
    s1 += partials[3 * i + 1];
    s2 += partials[3 * i + 2];
  }
  block_sum3(s0, s1, s2, out);
}

}  // namespace

extern "C" {

// Anchors per block, so the caller can size the partials buffer.
int zsg_match_loss_chunk() { return kChunk; }

// K1: launches the three kernels on `stream`; out = (cls_sum, box_sum,
// num_pos), best_out = each row's argmax-IoU anchor (B ints). Scratch, with
// n = B * ceil(A / kChunk): cand_v n floats, cand_i n ints, partials 3n
// floats. Returns the CUDA error code of the launches (0 on success).
int zsg_match_loss_fwd(const void* att, const void* bbx, const void* anc_tlbr,
                       const void* anc_cthw, const void* gt, const void* weight,
                       void* cand_v, void* cand_i, void* partials, void* out, void* best_out,
                       int batch, int num_anchors, float match_thr, float neg_thr, float alpha,
                       float gamma, float beta, void* stream) {
  if (batch <= 0 || batch > 65535 || num_anchors <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (num_anchors + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LossParams p{match_thr, neg_thr, alpha, gamma, beta};
  const dim3 grid(n_chunks, batch);
  chunk_best_anchor<<<grid, kThreads, 0, s>>>(
      static_cast<const float4*>(anc_tlbr), static_cast<const float4*>(gt),
      static_cast<float*>(cand_v), static_cast<int*>(cand_i), num_anchors);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_loss_partials<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(att), static_cast<const float4*>(bbx),
      static_cast<const float4*>(anc_tlbr), static_cast<const float4*>(anc_cthw),
      static_cast<const float4*>(gt), static_cast<const float*>(cand_v),
      static_cast<const int*>(cand_i), static_cast<const float*>(weight),
      static_cast<float*>(partials), static_cast<int*>(best_out), num_anchors, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials<<<1, kThreads, 0, s>>>(static_cast<const float*>(partials), batch * n_chunks,
                                      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K2: datt (B, A) and dbbx (B, A, 4) from the K1 inputs, K1's best_out and
// the upstream gradient grad_out (3 floats on the device). Returns the CUDA
// error code of the launch (0 on success).
int zsg_match_loss_bwd(const void* att, const void* bbx, const void* anc_tlbr,
                       const void* anc_cthw, const void* gt, const void* weight,
                       const void* best, const void* grad_out, void* datt, void* dbbx,
                       int batch, int num_anchors, float match_thr, float neg_thr, float alpha,
                       float gamma, float beta, void* stream) {
  if (batch <= 0 || batch > 65535 || num_anchors <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const LossParams p{match_thr, neg_thr, alpha, gamma, beta};
  const dim3 grid((num_anchors + kThreads - 1) / kThreads, batch);
  match_loss_grads<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(att), static_cast<const float4*>(bbx),
      static_cast<const float4*>(anc_tlbr), static_cast<const float4*>(anc_cthw),
      static_cast<const float4*>(gt), static_cast<const float*>(weight),
      static_cast<const int*>(best), static_cast<const float*>(grad_out),
      static_cast<float*>(datt), static_cast<float4*>(dbbx), num_anchors, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
