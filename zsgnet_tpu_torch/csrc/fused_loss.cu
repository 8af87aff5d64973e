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
// K1 is one launch of one thread-block cluster per row: the cluster's 8
// blocks (the portable maximum; 16 rows x 8 = 128 blocks on the H100's 132
// SMs at B = 16) split the row's anchors into 8 contiguous shares. Each
// block computes every IoU of its share once, keeps them in shared memory
// and reduces its (largest IoU, first index). The
// blocks exchange the 8 candidates through distributed shared memory, each
// merges them in rank order into the row's argmax-IoU anchor (the first of
// tied maxima, as jnp.argmax and torch.argmax; in the JAX package this
// prologue is XLA outside the Pallas kernel), then finishes labels, focal
// loss, targets and smooth-L1 from what it kept. Rank 0 adds the cluster's
// 8 partial triples in rank order into partials[row] and writes the row's
// argmax anchor to best_out, the residual K2 reads instead of searching
// again (the JAX VJP saves it in its aux array). The last cluster to
// finish, found with an integer ticket, adds partials[0..B) in row order
// into out. A share longer than kKeepMax anchors (rows of more than 65536
// anchors) is not kept: the second pass computes its IoUs again.
//
// K2 replaces fused_loss.py::_bwd_kernel (launched by _vjp_bwd): datt =
// g_cls * focal'(x) * valid * w and dbbx = g_box * smoothL1'(d) * pos * w
// (closed forms of _focal_grad_tile and _smooth_l1_and_grad). The upstream
// gradient (g_cls, g_box, g_num_pos) is read from device memory, so the
// backward never waits on the host; no atomics, no reduction, so it is
// deterministic. Both kernels take one thread per (row, anchor), 256
// anchors a block: grid (69, 16) at B = 16, A = 17451.
// match_loss_grads_pos_only is the one the wrapper launches. At every (row, anchor) it computes the IoU
// (without the division where the boxes do not meet), the labels and datt
// (one exp serves the sigmoid and the log1p; gamma 2 takes no powf) and
// stores dbbx = 0 with one 16-byte store; only at a positive anchor does it
// load the delta and the anchor's cthw and compute the targets and the
// smooth-L1 gradient. A grid of one wave of resident blocks, each thread
// taking one anchor over a group of 2 or 4 rows (its tlbr read once for the
// group), was slower on the card: there is about one (row, anchor) per
// resident thread, and a thread's rows run one after the other.
// match_loss_grads is the first kernel (the whole closed form at every
// anchor), kept to be timed beside it; it gives what the JAX kernel gives on
// finite inputs only.
//
// K2's bound: what the function needs is att and the anchors' tlbr read,
// datt and dbbx written, and the delta and the cthw of positive anchors read:
// B*A*(4 + 4 + 16) + A*16 bytes plus 32 per positive (6.98 MB at B = 16,
// A = 17451), 2.1 us at 3.35 TB/s. Its arithmetic per (row, anchor) (an IEEE
// division for the IoU, one for the sigmoid, an exp and a log1p) is a few
// dozen operations, far under the byte bound at the card's float32 rate; in
// practice a launch this short is bound by its own latency and issue.
//
// Non-finite inputs give what the JAX kernel gives as XLA compiles it: there
// a product with a 0/1 label becomes a select, so x * pos is 0 at a
// non-positive anchor whatever x holds, and datt and dbbx are exact zeros
// where valid and pos are 0, while the forward's loss * pos_w (pos_w = pos
// * w, no select) turns the box sum NaN when a non-positive anchor's delta is
// not finite. jnp.sign(NaN) is NaN.
//
// K1's bound: each input is read once and three floats are written, so the
// function moves B*A*20 + A*32 bytes (6.1 MB at B = 16, A = 17451): under
// 2 us at the H100's 3.35 TB/s. Per (row, anchor) it does a few dozen
// float operations and four transcendentals, far below the byte bound, so
// in practice the latency of one launch and of its dependent steps (load,
// cluster exchange, ticket) and the arithmetic of the loss itself (IEEE
// divisions, exp, log1p, log: the loops are kept rolled, because unrolled
// over a thread's anchors the code outgrew the instruction cache and ran
// twice as long) bound it. The design reads each input once with coalesced
// 16-byte loads, computes each IoU once, and pays for the box targets'
// logarithms and divisions only at the few positive anchors.
//
// Reduction: deterministic, no float atomics. The TPU kernel carries the
// sum across sequential grid steps; Hopper blocks run in no order, so each
// block reduces its threads' partials with warp shuffles and shared memory,
// rank 0 adds the 8 blocks' triples in rank order, and the last cluster
// adds the rows in row order. The integer ticket (atomicAdd on a counter
// that the wrapper keeps per device and stream) decides only which cluster
// does that last sum, never the order of a float addition, so the result is
// bit-identical from call to call. The counter returns to 0 at the end of
// every call; two streams must not share one, because two calls in flight
// would draw from the same sequence of tickets and neither, or the wrong
// one, would see the last.
//
// Build: nvcc compiles this file's plain C interface into a shared library
// that zsgnet_tpu_torch/ops/cuda/build.py loads with ctypes. Compiled with -fmad=false so the IoU
// and target arithmetic rounds like the plain PyTorch version, which
// matters only at label thresholds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;     // K2: one thread per anchor, 256 anchors a block
constexpr int kRowThreads = 512;  // K1: threads of a block of a row's cluster (256 and 1024 were slower)
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kCluster = 8;   // blocks per row: the portable maximum cluster size
constexpr int kKeepMax = 8192;  // longest share whose IoUs wait in shared memory (32 KB)

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
  __shared__ float smem[3][kRowWarps];
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
    float s0 = lane < kRowWarps ? smem[0][lane] : 0.f;
    float s1 = lane < kRowWarps ? smem[1][lane] : 0.f;
    float s2 = lane < kRowWarps ? smem[2][lane] : 0.f;
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
  // Most anchors do not meet the box: their IoU is 0 without the division.
  return inter > 0.f && uni > 0.f ? inter / uni : 0.f;
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

// d smooth_l1 / d pred as jnp: d / beta inside beta, else sign(d), which is
// NaN for NaN (torch.sign gives 0 there).
__device__ __forceinline__ float smooth_l1_grad_sign(float pred, float target, float beta) {
  const float d = pred - target;
  if (fabsf(d) < beta) return d / beta;
  return d > 0.f ? 1.f : (d < 0.f ? -1.f : d);
}

// d focal / d logit for match_loss_grads_pos_only: the closed form of
// focal_grad, with one e = exp(-|x|) for both the sigmoid and the log1p,
// x * pos as a select, and gamma 2 without powf.
__device__ __forceinline__ float focal_grad_one_exp(float x, bool is_pos, float alpha, float gamma) {
  const float pos = is_pos ? 1.f : 0.f;
  const float e = expf(-fabsf(x));
  const float inv = 1.f / (1.f + e);
  const float prob = x >= 0.f ? inv : e * inv;
  const float p_t = prob * pos + (1.f - prob) * (1.f - pos);
  const float alpha_t = alpha * pos + (1.f - alpha) * (1.f - pos);
  const float bce = fmaxf(x, 0.f) - (is_pos ? x : 0.f) + log1pf(e);
  const float one_m = 1.f - p_t;
  const float dpt = (2.f * pos - 1.f) * prob * (1.f - prob);
  const float m1 = gamma == 2.f ? one_m : powf(one_m, gamma - 1.f);
  const float m2 = gamma == 2.f ? one_m * one_m : powf(one_m, gamma);
  return alpha_t * (-gamma * m1 * dpt * bce + m2 * (prob - pos));
}

// One anchor's weighted terms, added to (cls, box, npos).
__device__ __forceinline__ void add_anchor_terms(float iou, bool is_best, float x, float4 d, float4 c,
                                                 float4 g, float w, const LossParams& p, float& cls,
                                                 float& box, float& npos) {
  const bool is_pos = iou >= p.match_thr || is_best;
  const bool is_valid = is_pos || iou < p.neg_thr;
  const float pos = is_pos ? 1.f : 0.f;

  // Sigmoid focal loss, as ops/losses.py::sigmoid_focal_loss; x * pos and
  // focal * valid are selects, as in the JAX kernel (see the top).
  const float bce = fmaxf(x, 0.f) - (is_pos ? x : 0.f) + log1pf(expf(-fabsf(x)));
  const float prob = 1.f / (1.f + expf(-x));
  const float p_t = prob * pos + (1.f - prob) * (1.f - pos);
  const float alpha_t = p.alpha * pos + (1.f - p.alpha) * (1.f - pos);
  const float one_m = 1.f - p_t;
  // gamma 2, the recipe's: the plain version's pow(x, 2) is x * x as well.
  const float mod = p.gamma == 2.f ? one_m * one_m : powf(one_m, p.gamma);
  const float focal = alpha_t * mod * bce;
  cls += (is_valid ? focal : 0.f) * w;

  // The box terms carry the factor pos: a few anchors in ten thousand are
  // positive, and only they pay for the targets' logarithms and divisions.
  // For the others the plain version adds loss * 0: an exact 0, or NaN where
  // the delta is not finite.
  if (!is_pos) {
    if (!(isfinite(d.x) && isfinite(d.y) && isfinite(d.z) && isfinite(d.w))) box = __int_as_float(0x7fffffff);
    return;
  }
  const float4 t4 = reg_targets(g, c);
  const float pos_w = pos * w;
  box += (smooth_l1(d.x, t4.x, p.beta) + smooth_l1(d.y, t4.y, p.beta) +
          smooth_l1(d.z, t4.z, p.beta) + smooth_l1(d.w, t4.w, p.beta)) *
         pos_w;
  npos += pos_w;
}

// K1. Grid (kCluster, B), one cluster per row; block `rank` of the cluster
// takes anchors [rank * share, min((rank + 1) * share, A)). KEEP: the share
// has at most kKeepMax anchors and its IoUs, computed once, wait in shared
// memory for the second pass; otherwise the second pass computes them again
// (the same arithmetic, so the same bits). partials (B, 3) is scratch;
// counter is the ticket, 0 between calls.
template <bool KEEP>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kRowThreads) match_loss_row_cluster(
    const float* __restrict__ att, const float4* __restrict__ bbx,
    const float4* __restrict__ anc_tlbr, const float4* __restrict__ anc_cthw,
    const float4* __restrict__ gt, const float* __restrict__ weight, float* __restrict__ partials,
    int* __restrict__ counter, float* __restrict__ out, int* __restrict__ best_out, int num_anchors,
    int share, LossParams p) {
  __shared__ float kept_iou[KEEP ? kKeepMax : 1];
  __shared__ float warp_v[kRowWarps];
  __shared__ int warp_i[kRowWarps];
  __shared__ float cand_v[kCluster];    // every block's candidate, written by its owner
  __shared__ int cand_i[kCluster];
  __shared__ float sums[kCluster][3];   // rank 0's copy collects every block's partials
  __shared__ float own[3];
  __shared__ int is_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4 g = gt[row];  // (ty, tx, by, bx)
  const float w = weight[row];
  const float area_g = area_tlbr(g);
  const size_t row_off = static_cast<size_t>(row) * num_anchors;
  const int begin = rank * share;
  const int end = min(begin + share, num_anchors);

  // Pass 1: every IoU of the share; this thread's largest and its first
  // index (a thread sees its anchors in increasing order: strict >).
  float v = -1.f;  // every IoU is >= 0, so a thread's first anchor is taken
  int idx = num_anchors;
  for (int a = begin + threadIdx.x; a < end; a += kRowThreads) {
    const float iou = iou_tlbr(g, area_g, anc_tlbr[a]);
    if constexpr (KEEP) kept_iou[a - begin] = iou;  // read back by this thread only
    if (iou > v) {
      v = iou;
      idx = a;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    argmax_merge(v, idx, __shfl_down_sync(0xffffffffu, v, off), __shfl_down_sync(0xffffffffu, idx, off));
  if (lane == 0) {
    warp_v[warp] = v;
    warp_i[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kRowWarps ? warp_v[lane] : -1.f;
    idx = lane < kRowWarps ? warp_i[lane] : num_anchors;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      argmax_merge(v, idx, __shfl_down_sync(0xffffffffu, v, off), __shfl_down_sync(0xffffffffu, idx, off));
    v = __shfl_sync(0xffffffffu, v, 0);
    idx = __shfl_sync(0xffffffffu, idx, 0);
    // Lane r writes this block's candidate into block r's shared memory.
    if (lane < kCluster) {
      cluster.map_shared_rank(cand_v, lane)[rank] = v;
      cluster.map_shared_rank(cand_i, lane)[rank] = idx;
    }
  }
  cluster.sync();

  // The row's argmax-IoU anchor: candidates merged in rank order, so the
  // first share holding the maximum wins.
  float best_v = cand_v[0];
  int best = cand_i[0];
#pragma unroll
  for (int r = 1; r < kCluster; ++r) argmax_merge(best_v, best, cand_v[r], cand_i[r]);

  // Pass 2: labels, losses and targets of the share.
  float cls = 0.f, box = 0.f, npos = 0.f;
#pragma unroll 1
  for (int a = begin + threadIdx.x; a < end; a += kRowThreads) {
    const float iou = KEEP ? kept_iou[a - begin] : iou_tlbr(g, area_g, anc_tlbr[a]);
    add_anchor_terms(iou, a == best, att[row_off + a], bbx[row_off + a], anc_cthw[a], g, w, p, cls, box,
                     npos);
  }
  block_sum3(cls, box, npos, own);  // thread 0 holds the sums and has written them to own
  if (threadIdx.x == 0) {
    float* dst = cluster.map_shared_rank(&sums[0][0], 0) + rank * 3;
    dst[0] = own[0];
    dst[1] = own[1];
    dst[2] = own[2];
  }
  cluster.sync();  // nothing reads another block's shared memory after this
  if (rank != 0) return;

  if (threadIdx.x == 0) {
    float s0 = sums[0][0], s1 = sums[0][1], s2 = sums[0][2];
#pragma unroll
    for (int r = 1; r < kCluster; ++r) {
      s0 += sums[r][0];
      s1 += sums[r][1];
      s2 += sums[r][2];
    }
    partials[3 * row] = s0;
    partials[3 * row + 1] = s1;
    partials[3 * row + 2] = s2;
    best_out[row] = best;
    __threadfence();  // the row's sums are visible before its ticket is drawn
    is_last = atomicAdd(counter, 1) == static_cast<int>(gridDim.y) - 1;
  }
  __syncthreads();
  if (!is_last) return;

  // The last cluster: every row's sums are in partials. Rows in a fixed
  // order (thread i takes rows i, i + kRowThreads, ...; then the tree).
  __threadfence();
  const int n = static_cast<int>(gridDim.y);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    s0 += __ldcg(partials + 3 * i);
    s1 += __ldcg(partials + 3 * i + 1);
    s2 += __ldcg(partials + 3 * i + 2);
  }
  __syncthreads();  // block_sum3's shared memory is free again
  block_sum3(s0, s1, s2, out);
  if (threadIdx.x == 0) *counter = 0;  // ready for the next call on this stream
}

// K2's first kernel. Block (anchor block, row), one thread per anchor.
// best_idx is K1's best_out; grad_out = (g_cls, g_box, g_num_pos) lives on
// the device.
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

// K2, the kernel the wrapper launches. Block (anchor block, row), one
// thread per anchor, as match_loss_grads; the box work only at positives.
__global__ void __launch_bounds__(kThreads) match_loss_grads_pos_only(
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
  const size_t i = static_cast<size_t>(row) * num_anchors + a;
  const float x = att[i];  // loaded before the IoU, not under the label's branch
  const float iou = iou_tlbr(g, area_tlbr(g), anc_tlbr[a]);
  const bool is_pos = iou >= p.match_thr || a == best_idx[row];
  const bool is_valid = is_pos || iou < p.neg_thr;
  datt[i] = (is_valid ? grad_out[0] * focal_grad_one_exp(x, is_pos, p.alpha, p.gamma) : 0.f) * w;
  if (!is_pos) {
    const float z = 0.f * w;
    dbbx[i] = make_float4(z, z, z, z);
    return;
  }
  const float g_box = grad_out[1];
  const float4 d = bbx[i];
  const float4 t4 = reg_targets(g, anc_cthw[a]);
  dbbx[i] = make_float4((g_box * smooth_l1_grad_sign(d.x, t4.x, p.beta)) * w,
                        (g_box * smooth_l1_grad_sign(d.y, t4.y, p.beta)) * w,
                        (g_box * smooth_l1_grad_sign(d.z, t4.z, p.beta)) * w,
                        (g_box * smooth_l1_grad_sign(d.w, t4.w, p.beta)) * w);
}

}  // namespace

extern "C" {

// K1: one cluster launch on `stream`; out = (cls_sum, box_sum, num_pos),
// best_out = each row's argmax-IoU anchor (B ints). partials is scratch of
// 3 * B floats; counter is one int that is 0 before the first call and that
// only calls on this stream use. The kept-in-registers instance is chosen by
// the share's length alone. Returns the CUDA error code of the launch (0 on
// success).
int zsg_match_loss_fwd(const void* att, const void* bbx, const void* anc_tlbr,
                       const void* anc_cthw, const void* gt, const void* weight,
                       void* partials, void* counter, void* out, void* best_out,
                       int batch, int num_anchors, float match_thr, float neg_thr, float alpha,
                       float gamma, float beta, void* stream) {
  if (batch <= 0 || batch > 65535 || num_anchors <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int share = (num_anchors + kCluster - 1) / kCluster;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LossParams p{match_thr, neg_thr, alpha, gamma, beta};
  const dim3 grid(kCluster, batch);
#define ZSG_K1_LAUNCH(KEEP)                                                                        \
  match_loss_row_cluster<KEEP><<<grid, kRowThreads, 0, s>>>(                                       \
      static_cast<const float*>(att), static_cast<const float4*>(bbx),                             \
      static_cast<const float4*>(anc_tlbr), static_cast<const float4*>(anc_cthw),                  \
      static_cast<const float4*>(gt), static_cast<const float*>(weight),                           \
      static_cast<float*>(partials), static_cast<int*>(counter), static_cast<float*>(out),         \
      static_cast<int*>(best_out), num_anchors, share, p)
  if (share <= kKeepMax) {
    ZSG_K1_LAUNCH(true);
  } else {
    ZSG_K1_LAUNCH(false);
  }
#undef ZSG_K1_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// K2: datt (B, A) and dbbx (B, A, 4) from the K1 inputs, K1's best_out and
// the upstream gradient grad_out (3 floats on the device), by the kernel
// `kernel` names: 0 match_loss_grads_pos_only, 1 match_loss_grads. Returns
// the CUDA error code of the launch (0 on success).
int zsg_match_loss_bwd(int kernel, const void* att, const void* bbx, const void* anc_tlbr,
                       const void* anc_cthw, const void* gt, const void* weight,
                       const void* best, const void* grad_out, void* datt, void* dbbx,
                       int batch, int num_anchors, float match_thr, float neg_thr, float alpha,
                       float gamma, float beta, void* stream) {
  if (batch <= 0 || batch > 65535 || num_anchors <= 0 || kernel < 0 || kernel > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const LossParams p{match_thr, neg_thr, alpha, gamma, beta};
  const dim3 grid((num_anchors + kThreads - 1) / kThreads, batch);
  auto* launch = kernel == 0 ? match_loss_grads_pos_only : match_loss_grads;
  launch<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(att), static_cast<const float4*>(bbx),
      static_cast<const float4*>(anc_tlbr), static_cast<const float4*>(anc_cthw),
      static_cast<const float4*>(gt), static_cast<const float*>(weight),
      static_cast<const int*>(best), static_cast<const float*>(grad_out),
      static_cast<float*>(datt), static_cast<float4*>(dbbx), num_anchors, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
