// Fused inference ResNet bottleneck, stride 1 (kernel K3):
//
//   h1 = relu(s1 * conv1x1(x, w1) + b1)
//   h2 = relu(s2 * conv3x3(h1, w2) + b2)          (zero padding 1)
//   y  = relu(s3 * conv1x1(h2, w3) + b3 + r),
//   r  = x (identity, Cin == Cout) or sd * conv1x1(x, wd) + bd (projection).
//
// Replaces the Pallas TPU kernel zsgnet_tpu/ops/pallas/fused_bottleneck.py::_kernel
// (:53), launched by fused_bottleneck_infer (:148). It computes the same
// function with the rounding points of the plain version
// (zsgnet_tpu_torch/ops/cuda/fused_bottleneck.py::bottleneck_infer_reference):
// bf16 operands with float32 accumulation, h1 and h2 rounded to bf16,
// BatchNorm folded into float32 per-channel scale and bias, the identity
// residual added in float32 from x in its own dtype, the output in x's dtype.
//
// Layout: x (B, H, W, Cin) NHWC, bf16 or float32, contiguous, 16-byte
// aligned; weights float32 in the JAX layout: w1 (Cin, Cmid), w2 (3, 3,
// Cmid, Cmid) HWIO, w3 (Cmid, Cout), wd (Cin, Cout); scales and biases
// float32 vectors. Any H and W; Cin and Cout multiples of 16; Cmid up to 64,
// padded with zeros to 16 or 64 in shared memory (a zero weight column with
// zero scale and bias gives a zero channel, which adds nothing).
// None of the TPU kernel's tiling artifacts are kept: no W padding to a
// multiple of 8, no (8, 128) alignment, no dx-shifted copies of h1.
//
// Bound on the H100 (3.35 TB/s HBM3, 989 TFLOP/s bf16 dense), counting x
// read once, y written once and the weights:
//   identity   [16, 75, 75, 256], Cmid 64:   92.3 MB -> 27.6 us; 12.5 GFLOP -> 12.7 us: bytes.
//   projection [16, 75, 75, 64] -> 256:      57.8 MB -> 17.2 us; 13.3 GFLOP -> 13.4 us: bytes, narrowly.
// What the design does about it: x and y cross device memory once each; h1
// and h2 never leave shared memory (an unfused chain writes and reads back
// every intermediate, about five times the bytes).
//
// Design. Persistent blocks of 8 warps, as many as fit on the card (one per
// SM at layer1 width, where the block uses 219 KB of shared memory). Each
// block converts the weights to bf16 into shared memory once, transposed to
// (N, K) rows, then walks 8 x 8 output tiles, blockIdx.x + i * gridDim.x:
//   1. the 10 x 10 halo tile of x goes to shared memory as bf16 (cp.async
//      with zero fill outside the image for bf16 x; loads and converts for
//      float32 x);
//   2. h1 over the 100 halo pixels, mma.sync m16n8k16 (bf16 -> f32) with
//      ldmatrix; a halo pixel outside the image gets h1 = 0, not relu(b1):
//      that is conv2's zero padding (the TPU kernel's masks at :102-115);
//   3. h2 over the 64 tile pixels as 9 shifted GEMMs; ldmatrix takes one
//      row address per lane, so a tap's shift is only an address offset.
//      h2 overwrites h1 in shared memory once every warp has read it;
//   4. y in chunks of 16 output channels with h2's A fragments held in
//      registers, plus the projection GEMM on the same x tile or the
//      identity residual read from x; pixels outside the image are not
//      stored.
// The halo recompute of stage 1 costs 100/64 of its work. For the identity
// variant the next tile's x copy is issued after stage 1 and overlaps
// stages 2 and 3. Blocks share nothing and carry nothing from one tile to
// the next except the weights, so the order in which the card runs them
// does not matter (the TPU grid's sequential scratch is gone). No atomics:
// each output is written by one thread in a fixed order, so the result is
// deterministic. Simple first: no wgmma, no TMA, no multi-stage pipeline.
//
// Build: nvcc compiles this file's plain C interface into a shared library
// that zsgnet_tpu_torch/ops/cuda/build.py loads with ctypes (-fmad=false, so
// the epilogues' s * acc + b round like the plain version's mul and add).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 8;                    // output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 2;            // halo tile side
constexpr int kHaloPix = kHalo * kHalo;     // 100
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements after each shared row: ldmatrix rows hit distinct banks

struct Params {
  const void* x;
  const float *w1, *s1, *b1, *w2, *s2, *b2, *w3, *s3, *b3, *wd, *sd, *bd;
  void* out;
  int B, H, W, cin, cmid, cout;
  int tiles_y, tiles_x, n_tiles;
};

// Byte offsets of the shared-memory regions; pitches in bf16 elements.
struct Layout {
  int px, pm;  // pitch of a Cin-wide row and of a Cmid-wide row
  size_t x, w1, w2, w3, wd, h, f, bytes;
};

__host__ __device__ inline Layout make_layout(int cin, int cm, int cout, bool proj) {
  Layout L;
  L.px = cin + kPad;
  L.pm = cm + kPad;
  size_t o = 0;
  L.x = o;
  o += static_cast<size_t>(kHaloPix) * L.px * 2;
  L.w1 = o;
  o += static_cast<size_t>(cm) * L.px * 2;
  L.w2 = o;
  o += static_cast<size_t>(9) * cm * L.pm * 2;
  L.w3 = o;
  o += static_cast<size_t>(cout) * L.pm * 2;
  L.wd = o;
  if (proj) o += static_cast<size_t>(cout) * L.px * 2;
  L.h = o;  // h1 (100 rows), then h2 (64 rows) in the same place
  o += static_cast<size_t>(kHaloPix) * L.pm * 2;
  L.f = o;  // s1 b1 s2 b2 [cm each], s3 b3 [cout each], sd bd [cout each] if proj
  o += static_cast<size_t>(4 * cm + (proj ? 4 : 2) * cout) * 4;
  L.bytes = o;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of NJ consecutive n8 tiles from (N, K) rows. `addr` is this
// lane's address for the first pair: row (lane & 7) + 8 * (lane >> 4), column
// 8 * ((lane >> 3) & 1), plus the k offset; `stride` is 8 rows in bytes.
template <int NJ>
__device__ __forceinline__ void load_b(uint32_t (&b)[NJ][2], uint32_t addr, int stride) {
#pragma unroll
  for (int j = 0; j + 1 < NJ; j += 2) ldsm_x4(addr + j * stride, b[j][0], b[j][1], b[j + 1][0], b[j + 1][1]);
  if constexpr (NJ % 2 == 1) ldsm_x2(addr + (NJ - 1) * stride, b[NJ - 1][0], b[NJ - 1][1]);
}

__device__ __forceinline__ uint32_t b_lane_offset(int lane, int pitch) {
  return static_cast<uint32_t>((((lane & 7) + ((lane >> 4) << 3)) * pitch + ((lane >> 3) & 1) * 8) * 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (std::is_same<T, bf16>::value) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  } else {
    return *reinterpret_cast<const float2*>(p);
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (std::is_same<T, bf16>::value) {
    store_bf16x2(p, lo, hi);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  }
}

struct TileXY {
  int b, y0, x0;
};

__device__ __forceinline__ TileXY tile_at(const Params& p, int tile) {
  const int per_img = p.tiles_y * p.tiles_x;
  const int b = tile / per_img;
  const int r = tile - b * per_img;
  return {b, (r / p.tiles_x) * kTile, (r % p.tiles_x) * kTile};
}

// The 10 x 10 halo tile of x as bf16 rows of Cin; zeros outside the image.
template <typename T>
__device__ void load_x_tile(const Params& p, TileXY t, bf16* sx, int px) {
  const T* x = static_cast<const T*>(p.x);
  const int chunks = p.cin / 8;  // 8 channels: 16 bytes of bf16
  for (int i = threadIdx.x; i < kHaloPix * chunks; i += kThreads) {
    const int q = i / chunks;
    const int c = i - q * chunks;
    const int gy = t.y0 - 1 + q / kHalo;
    const int gx = t.x0 - 1 + q % kHalo;
    const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    const size_t src = in ? ((static_cast<size_t>(t.b) * p.H + gy) * p.W + gx) * p.cin + c * 8 : 0;
    bf16* dst = sx + q * px + c * 8;
    if constexpr (std::is_same<T, bf16>::value) {
      // src-size 0 reads nothing and fills the 16 bytes with zeros.
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                   "l"(x + src), "r"(in ? 16 : 0));
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in) {
        const float4 a = *reinterpret_cast<const float4*>(x + src);
        const float4 b = *reinterpret_cast<const float4*>(x + src + 4);
        v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
}

__device__ __forceinline__ void wait_x_tile() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Weights to bf16 (N, K) rows, Cmid padded to CM with zeros; scales and biases as float32.
template <int CM>
__device__ void load_weights(const Params& p, const Layout& L, unsigned char* smem) {
  const int cin = p.cin, cmid = p.cmid, cout = p.cout;
  bf16* w1 = reinterpret_cast<bf16*>(smem + L.w1);
  bf16* w2 = reinterpret_cast<bf16*>(smem + L.w2);
  bf16* w3 = reinterpret_cast<bf16*>(smem + L.w3);
  for (int i = threadIdx.x; i < cin * CM; i += kThreads) {  // w1 (Cin, Cmid) -> [n][k]
    const int k = i / CM, n = i % CM;
    w1[n * L.px + k] = __float2bfloat16(n < cmid ? p.w1[k * cmid + n] : 0.f);
  }
  for (int i = threadIdx.x; i < 9 * CM * CM; i += kThreads) {  // w2 (3, 3, Cmid, Cmid) -> [tap][co][ci]
    const int tap = i / (CM * CM);
    const int ci = (i / CM) % CM, co = i % CM;
    const float v = (ci < cmid && co < cmid) ? p.w2[(tap * cmid + ci) * cmid + co] : 0.f;
    w2[(tap * CM + co) * L.pm + ci] = __float2bfloat16(v);
  }
  for (int i = threadIdx.x; i < CM * cout; i += kThreads) {  // w3 (Cmid, Cout) -> [co][ci]
    const int ci = i / cout, co = i % cout;
    w3[co * L.pm + ci] = __float2bfloat16(ci < cmid ? p.w3[ci * cout + co] : 0.f);
  }
  if (p.wd != nullptr) {
    bf16* wd = reinterpret_cast<bf16*>(smem + L.wd);
    for (int i = threadIdx.x; i < cin * cout; i += kThreads) {  // wd (Cin, Cout) -> [co][k]
      const int k = i / cout, co = i % cout;
      wd[co * L.px + k] = __float2bfloat16(p.wd[k * cout + co]);
    }
  }
  float* f = reinterpret_cast<float*>(smem + L.f);
  for (int i = threadIdx.x; i < CM; i += kThreads) {
    const bool ok = i < cmid;
    f[i] = ok ? p.s1[i] : 0.f;
    f[CM + i] = ok ? p.b1[i] : 0.f;
    f[2 * CM + i] = ok ? p.s2[i] : 0.f;
    f[3 * CM + i] = ok ? p.b2[i] : 0.f;
  }
  for (int i = threadIdx.x; i < cout; i += kThreads) {
    f[4 * CM + i] = p.s3[i];
    f[4 * CM + cout + i] = p.b3[i];
    if (p.wd != nullptr) {
      f[4 * CM + 2 * cout + i] = p.sd[i];
      f[4 * CM + 3 * cout + i] = p.bd[i];
    }
  }
}

template <typename T, int CM>
__global__ void __launch_bounds__(kThreads) bottleneck_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool proj = p.wd != nullptr;
  const Layout L = make_layout(p.cin, CM, p.cout, proj);
  const int px = L.px, pm = L.pm;
  bf16* sx = reinterpret_cast<bf16*>(smem + L.x);
  bf16* sh = reinterpret_cast<bf16*>(smem + L.h);
  const float* s1 = reinterpret_cast<const float*>(smem + L.f);
  const float* b1 = s1 + CM;
  const float* s2 = b1 + CM;
  const float* b2 = s2 + CM;
  const float* s3 = b2 + CM;
  const float* b3 = s3 + p.cout;
  const float* sd = b3 + p.cout;
  const float* bd = sd + p.cout;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);

  load_weights<CM>(p, L, smem);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int mg = warp & 3;  // m group
  const int ng = warp >> 2;  // n group
  const int g = lane >> 2, t4 = lane & 3;
  const int a_col = (lane >> 4) * 8;  // A fragment: lane gives row lane & 15, column a_col
  constexpr int NJ = CM / 16;         // n8 tiles a warp owns in stages 1 and 2 (half of CM)
  const int n0 = ng * (CM / 2);

  // Shared addresses that do not depend on the tile.
  uint32_t a1_addr[2];  // stage 1: two m16 tiles of halo rows (rows past 99 read row 99, unused)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min((mg * 2 + i) * 16 + (lane & 15), kHaloPix - 1);
    a1_addr[i] = smem_u32(sx + row * px + a_col);
  }
  const uint32_t b1_addr = smem_u32(smem + L.w1) + b_lane_offset(lane, px) + n0 * px * 2;
  const int pa = mg * 16 + (lane & 15);  // this lane's A row among the 64 tile pixels
  const uint32_t a2_addr = smem_u32(sh + ((pa / kTile) * kHalo + pa % kTile) * pm + a_col);
  const uint32_t b2_addr = smem_u32(smem + L.w2) + b_lane_offset(lane, pm) + n0 * pm * 2;
  const uint32_t a3_addr = smem_u32(sh + pa * pm + a_col);
  const uint32_t ad_addr = smem_u32(sx + ((pa / kTile + 1) * kHalo + pa % kTile + 1) * px + a_col);
  const uint32_t b3_addr = smem_u32(smem + L.w3) + b_lane_offset(lane, pm);
  const uint32_t bd_addr = smem_u32(smem + L.wd) + b_lane_offset(lane, px);

  int tile = blockIdx.x;
  if (tile < p.n_tiles) load_x_tile<T>(p, tile_at(p, tile), sx, px);
  for (; tile < p.n_tiles; tile += gridDim.x) {
    const TileXY tl = tile_at(p, tile);
    const int next = tile + gridDim.x;
    wait_x_tile();
    __syncthreads();

    // Stage 1: h1 over the halo tile, M = 100 (as 8 m16 tiles), N = CM, K = Cin.
    {
      float acc[2][NJ][4] = {};
      for (int k = 0; k < p.cin; k += 16) {
        uint32_t a[2][4], b[NJ][2];
        ldsm_x4(a1_addr[0] + k * 2, a[0]);
        ldsm_x4(a1_addr[1] + k * 2, a[1]);
        load_b<NJ>(b, b1_addr + k * 2, 8 * px * 2);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma(acc[i][j], a[i], b[j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = (mg * 2 + i) * 16 + g + 8 * hh;
          if (row < kHaloPix) {
            const int gy = tl.y0 - 1 + row / kHalo;
            const int gx = tl.x0 - 1 + row % kHalo;
            const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              const int c = n0 + j * 8 + 2 * t4;
              const float v0 = in ? fmaxf(acc[i][j][2 * hh] * s1[c] + b1[c], 0.f) : 0.f;
              const float v1 = in ? fmaxf(acc[i][j][2 * hh + 1] * s1[c + 1] + b1[c + 1], 0.f) : 0.f;
              store_bf16x2(sh + row * pm + c, v0, v1);
            }
          }
        }
      }
    }
    __syncthreads();
    if (!proj && next < p.n_tiles) load_x_tile<T>(p, tile_at(p, next), sx, px);  // sx is free now

    // Stage 2: h2 over the 64 tile pixels, 9 taps x K = CM, N = CM.
    {
      float acc[NJ][4] = {};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t a_tap = a2_addr + ((tap / 3) * kHalo + tap % 3) * pm * 2;
        const uint32_t b_tap = b2_addr + tap * CM * pm * 2;
#pragma unroll
        for (int k = 0; k < CM; k += 16) {
          uint32_t a[4], b[NJ][2];
          ldsm_x4(a_tap + k * 2, a);
          load_b<NJ>(b, b_tap + k * 2, 8 * pm * 2);
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma(acc[j], a, b[j]);
        }
      }
      __syncthreads();  // every warp has read h1: h2 may overwrite it
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = mg * 16 + g + 8 * hh;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = n0 + j * 8 + 2 * t4;
          store_bf16x2(sh + row * pm + c, fmaxf(acc[j][2 * hh] * s2[c] + b2[c], 0.f),
                       fmaxf(acc[j][2 * hh + 1] * s2[c + 1] + b2[c + 1], 0.f));
        }
      }
    }
    __syncthreads();

    // Stage 3: y over the 64 tile pixels in chunks of 16 output channels, K = CM,
    // plus the projection (K = Cin on the same x tile) or the identity residual.
    {
      uint32_t a[CM / 16][4];
#pragma unroll
      for (int ks = 0; ks < CM / 16; ++ks) ldsm_x4(a3_addr + ks * 32, a[ks]);
      size_t pix[2];
      bool ok[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pp = mg * 16 + g + 8 * hh;
        const int gy = tl.y0 + pp / kTile, gx = tl.x0 + pp % kTile;
        ok[hh] = gy < p.H && gx < p.W;
        pix[hh] = (static_cast<size_t>(tl.b) * p.H + gy) * p.W + gx;
      }
      for (int chunk = ng; chunk < p.cout / 16; chunk += 2) {
        const int nb = chunk * 16;
        float y[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < CM / 16; ++ks) {
          uint32_t b[2][2];
          load_b<2>(b, b3_addr + (nb * pm + ks * 16) * 2, 8 * pm * 2);
          mma(y[0], a[ks], b[0]);
          mma(y[1], a[ks], b[1]);
        }
        float r[2][4] = {};
        if (proj) {
          for (int k = 0; k < p.cin; k += 16) {
            uint32_t ad[4], b[2][2];
            ldsm_x4(ad_addr + k * 2, ad);
            load_b<2>(b, bd_addr + (nb * px + k) * 2, 8 * px * 2);
            mma(r[0], ad, b[0]);
            mma(r[1], ad, b[1]);
          }
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (!ok[hh]) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = nb + j * 8 + 2 * t4;
            float v0 = y[j][2 * hh] * s3[c] + b3[c];
            float v1 = y[j][2 * hh + 1] * s3[c + 1] + b3[c + 1];
            if (proj) {
              v0 += r[j][2 * hh] * sd[c] + bd[c];
              v1 += r[j][2 * hh + 1] * sd[c + 1] + bd[c + 1];
            } else {
              const float2 res = load2<T>(x + pix[hh] * p.cin + c);
              v0 += res.x;
              v1 += res.y;
            }
            store2<T>(out + pix[hh] * p.cout + c, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
          }
        }
      }
    }
    if (proj) {
      __syncthreads();  // stage 3 has read the x tile
      if (next < p.n_tiles) load_x_tile<T>(p, tile_at(p, next), sx, px);
    }
  }
}

// Two instances: Cmid up to 16 (small shapes) and up to 64 (layer1).
int padded_cmid(int cmid) { return cmid <= 16 ? 16 : 64; }

template <typename T, int CM>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = make_layout(p.cin, CM, p.cout, p.wd != nullptr).bytes;
  auto kernel = bottleneck_kernel<T, CM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = std::min(p.n_tiles, sms * per_sm);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  switch (padded_cmid(p.cmid)) {
    case 16: return launch<T, 16>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory in bytes that one block needs for these widths.
long long zsg_bottleneck_smem_bytes(int cin, int cmid, int cout, int has_proj) {
  return static_cast<long long>(make_layout(cin, padded_cmid(cmid), cout, has_proj != 0).bytes);
}

// Largest dynamic shared memory a block may opt into on the current device (-1 on error).
int zsg_bottleneck_max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return bytes;
}

// K3 on `stream`: out (B, H, W, Cout) in x's dtype (bf16 if x_is_bf16, else
// float32). wd, sd and bd are all null for the identity residual. Returns the
// CUDA error code of the launch (0 on success).
int zsg_bottleneck_infer(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
                         const void* s2, const void* b2, const void* w3, const void* s3, const void* b3,
                         const void* wd, const void* sd, const void* bd, void* out, int batch, int height,
                         int width, int cin, int cmid, int cout, int x_is_bf16, void* stream) {
  const bool proj = wd != nullptr;
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cin % 16 || cout <= 0 || cout % 16 ||
      cmid <= 0 || cmid > 64 || (!proj && cin != cout) || (proj && (sd == nullptr || bd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x;
  p.w1 = static_cast<const float*>(w1);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.w3 = static_cast<const float*>(w3);
  p.s3 = static_cast<const float*>(s3);
  p.b3 = static_cast<const float*>(b3);
  p.wd = static_cast<const float*>(wd);
  p.sd = static_cast<const float*>(sd);
  p.bd = static_cast<const float*>(bd);
  p.out = out;
  p.B = batch;
  p.H = height;
  p.W = width;
  p.cin = cin;
  p.cmid = cmid;
  p.cout = cout;
  p.tiles_y = (height + kTile - 1) / kTile;
  p.tiles_x = (width + kTile - 1) / kTile;
  const long long n_tiles = static_cast<long long>(batch) * p.tiles_y * p.tiles_x;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = static_cast<int>(n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? dispatch<bf16>(p, s) : dispatch<float>(p, s);
}

}  // extern "C"
