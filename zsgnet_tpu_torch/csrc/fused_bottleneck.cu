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
// float32 vectors. Any H, W and batch. None of the TPU kernel's tiling
// artifacts are kept: no W padding to a multiple of 8, no (8, 128)
// alignment, no dx-shifted copies of h1.
//
// Bound on the H100 (3.35 TB/s HBM3, 989 TFLOP/s bf16 dense), counting x
// read once, y written once and the weights:
//   identity   [16, 75, 75, 256], Cmid 64:   92.3 MB -> 27.6 us; 12.5 GFLOP -> 12.7 us: bytes.
//   projection [16, 75, 75, 64] -> 256:      57.8 MB -> 17.2 us; 13.3 GFLOP -> 13.4 us: bytes, narrowly.
// What the design does about it: x and y cross device memory once each; h1
// and h2 never leave the SM (an unfused chain writes and reads back every
// intermediate, about five times the bytes).
//
// The file holds two kernels, and the host code picks one from the shape
// alone before it launches (choose_variant, below).
//
// 1. The Hopper kernel (namespace wg), for Cmid 64 with Cin and Cout
// multiples of 64 up to 256 (Cin 64 with a projection): ResNet-50's layer1.
// One persistent block on each SM walks output tiles of 8 x 16 pixels (8 x 8
// is the other instance). Two consumer warpgroups own 64 output pixels
// each, a producer warpgroup gives them most of its registers (setmaxnreg)
// and keeps a ring of x chunks full:
//   - x arrives by TMA: a 4-D tensor map over (B, H, W, Cin) bf16, a box of
//     one halo tile (10 x 18 pixels) of 64 channels, the 128-byte swizzle,
//     zeros from the hardware outside the image. One thread issues a copy,
//     an mbarrier per ring slot reports it (phase bits tracked per slot
//     across the persistent loop). float32 x cannot go through a bf16 map:
//     the producer warpgroup loads, converts and stores the same swizzled
//     layout, then fence.proxy.async.
//   - the weights are packed once per set of weights by pack_weights_kernel
//     (bf16, (N, K) rows of 128 bytes, swizzled: Cmid 64 x 2 bytes is one
//     swizzle row, so no padding column) and fetched by each block with
//     three bulk copies that overlap the first x chunks (converting them
//     inside every block, all blocks reading the same float32 lines of L2
//     at once, made the launch about a sixth longer).
//   - stage 1 (h1 over the 180 halo pixels = 3 m64 tiles, K = Cin in ring
//     chunks) is wgmma with both operands in shared memory, one commit
//     group per chunk; the odd third m tile is split by columns between the
//     two warpgroups. Its first half of a tile's chunks is consumed in the
//     middle of the previous tile's stage 3, so that with a ring of only
//     half a tile (shared memory holds no more beside 138 KB of weights)
//     every chunk still has a stage's time to arrive.
//   - stage 2 (9 taps, K = 64 each) is wgmma with A from registers:
//     ldmatrix takes one row address per lane from the swizzled h1, so a
//     tap's shift stays an address offset; the 8-pixel runs of a tile, one
//     halo row apart and starting off the 8-row swizzle atom, are not
//     something a shared-memory descriptor strides over. One commit group
//     per tap, the next tap's fragments loaded while it runs.
//   - h2 never touches shared memory: the accumulator's register layout is
//     the A operand's, so relu(s2 * acc + b2) is rounded to bf16 straight
//     into stage 3's A fragments (and the projection's A fragments are
//     ldmatrix'ed from the x chunk before its slot is freed).
//   - stage 3 runs in chunks of 64 output channels. The identity residual
//     was taken from the x chunks as they passed through the ring (x's
//     centre pixels are the residual), so it costs no second read. bf16
//     output goes to shared memory (in h1's place) and leaves by one TMA
//     store per warpgroup and chunk: whole 128-byte rows instead of 4-byte
//     stores, the ragged edge clipped by the hardware. float32 output is
//     stored from the registers.
// The halo recompute of stage 1 costs 180/128 of its work. At 75 x 75 the
// 8 x 16 tiling gives 50 tiles an image: 800 at B = 16, 7 rounds over 132
// SMs with the last 6 % full (8 x 8: 100 an image, 1600, 13 rounds with the
// last 12 % full, and twice stage 1's work as issued).
//
// 2. The mma.sync kernel, for every other shape (Cin and Cout multiples of
// 16, Cmid up to 64 padded with zeros to 16 or 64 in shared memory: a zero
// weight column with zero scale and bias gives a zero channel, which adds
// nothing). Persistent blocks of 8 warps, as many as fit on the card. Each
// block converts the weights to bf16 into shared memory once, transposed to
// (N, K) rows, then walks 8 x 8 output tiles, blockIdx.x + i * gridDim.x:
//   1. the 10 x 10 halo tile of x goes to shared memory as bf16 (cp.async
//      with zero fill outside the image for bf16 x; loads and converts for
//      float32 x);
//   2. h1 over the 100 halo pixels, mma.sync m16n8k16 (bf16 -> f32) with
//      ldmatrix; a halo pixel outside the image gets h1 = 0, not relu(b1):
//      that is conv2's zero padding (the TPU kernel's masks at :102-115);
//   3. h2 over the 64 tile pixels as 9 shifted GEMMs; h2 overwrites h1 in
//      shared memory once every warp has read it;
//   4. y in chunks of 16 output channels with h2's A fragments held in
//      registers, plus the projection GEMM on the same x tile or the
//      identity residual read from x; pixels outside the image are not
//      stored.
//
// In both kernels blocks share nothing and carry nothing from one tile to
// the next except the weights (and the ring), so the order in which the
// card runs them does not matter (the TPU grid's sequential scratch is
// gone). No atomics: each output is written by one thread or one TMA store
// in a fixed order, so the result is deterministic.
//
// Build: nvcc compiles this file's plain C interface into a shared library
// that zsgnet_tpu_torch/ops/cuda/build.py loads with ctypes (-fmad=false, so
// the epilogues' s * acc + b round like the plain version's mul and add).

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled itself is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

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
__global__ void __launch_bounds__(kThreads) bottleneck_mma_kernel(const __grid_constant__ Params p) {
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
int launch_mma(const Params& p, cudaStream_t stream) {
  const size_t smem = make_layout(p.cin, CM, p.cout, p.wd != nullptr).bytes;
  auto kernel = bottleneck_mma_kernel<T, CM>;
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
int dispatch_mma(const Params& p, cudaStream_t stream) {
  switch (padded_cmid(p.cmid)) {
    case 16: return launch_mma<T, 16>(p, stream);
    case 64: return launch_mma<T, 64>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---------------------------------------------------------------------------
// The Hopper kernel: wgmma in every stage, TMA for x into an mbarrier ring.
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kRowBytes = 128;    // one pixel's 64 bf16 channels: the 128-byte swizzle span
constexpr int kAtomBytes = 1024;  // 8 such rows: the swizzle atom, and every region's alignment
constexpr int kChunkBytes = 64 * kRowBytes;  // 64 rows (one wgmma m or n extent) of 64 channels
constexpr int kMaxStages = 4;
constexpr int kMaxChunks = 4;  // Cin and Cout up to 256: loops over 64-channel chunks are unrolled
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take on sm_90

struct Params {
  const void* x;
  const unsigned char* packed;  // the block's weights as pack_weights_kernel leaves them
  void* out;
  int B, H, W, cin, cout;
  int tiles_y, tiles_x, n_tiles;
  int stages;
};

// The block's weights in the JAX layout, as the caller holds them.
struct Weights {
  const float *w1, *s1, *b1, *w2, *s2, *b2, *w3, *s3, *b3, *wd, *sd, *bd;
};

template <int TH, int TW>
struct Tile {
  static constexpr int kHaloH = TH + 2, kHaloW = TW + 2;
  static constexpr int kHaloPix = kHaloH * kHaloW;
  static constexpr int kM1 = (kHaloPix + 63) / 64;  // m64 tiles of stage 1 (halo rows)
  static constexpr int kGroups = TH * TW / 64;      // consumer warpgroups: one m64 tile of outputs each
  static constexpr int kConsumers = kGroups * 128;
  static constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
  static constexpr int kFull = kM1 / kGroups;        // whole stage-1 m tiles per warpgroup
  static constexpr int kRem = kM1 % kGroups;         // one more, split by columns between two warpgroups
  static constexpr int kStageBytes = kM1 * kChunkBytes;
  static constexpr int kHBytes = (kHaloPix * kRowBytes + kAtomBytes - 1) / kAtomBytes * kAtomBytes;
  static_assert(TH * TW % 64 == 0, "a tile is a whole number of m64 wgmma tiles");
  static_assert(kRem == 0 || (kGroups == 2 && kRem == 1), "stage 1's odd m tile is split in two");
};

// Byte offsets from the 1024-byte aligned base of dynamic shared memory.
// [w1, bars) is also the layout of the packed weights in device memory.
struct Layout {
  int x, h, w1, w2, w3, wd, f, bars, bytes;
};

template <int TH, int TW>
__host__ __device__ inline Layout make_layout(int cin, int cout, bool proj, int stages) {
  using TL = Tile<TH, TW>;
  Layout L;
  int o = 0;
  L.x = o;  // `stages` slots of one 64-channel chunk of the halo tile
  o += stages * TL::kStageBytes;
  L.h = o;  // h1 over the halo tile
  o += TL::kHBytes;
  L.w1 = o;  // [cin / 64][64 n][64 k]
  o += cin / 64 * kChunkBytes;
  L.w2 = o;  // [tap][64 n][64 k]
  o += 9 * kChunkBytes;
  L.w3 = o;  // [cout / 64][64 n][64 k]
  o += cout / 64 * kChunkBytes;
  L.wd = o;  // the same (cin is 64)
  if (proj) o += cout / 64 * kChunkBytes;
  L.f = o;  // s1 b1 s2 b2 [64 each], s3 b3 [cout each], sd bd [cout each] if proj
  o += (4 * 64 + (proj ? 4 : 2) * cout) * 4;
  L.bars = o;  // full[kMaxStages], empty[kMaxStages], weights[3]
  o += (2 * kMaxStages + 3) * 8;
  L.bytes = o + kAtomBytes;  // room to align the base
  return L;
}

// Ring slots that fit beside everything else (0: the widths do not fit at all).
template <int TH, int TW>
int stages_that_fit(int cin, int cout, bool proj) {
  const int fixed = make_layout<TH, TW>(cin, cout, proj, 0).bytes;
  const int fit = (kSmemLimit - fixed) / Tile<TH, TW>::kStageBytes;
  return fit < 2 ? 0 : std::min(fit, kMaxStages);
}

// ---- PTX wrappers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's ordinary shared-memory writes before reads by wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// One box of the (B, H, W, Cin) tensor map into shared memory; coordinates
// innermost first, out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory into the (B, H, W, C) tensor map; the part of
// the box outside the tensor is not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Until this thread's stores have read their shared memory / have completed.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// `bytes` (a multiple of 16) of contiguous device memory into shared memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes: the compiler
// may not move their uses across this point.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Shared-memory matrix descriptor: K-major rows of 128 bytes with the
// 128-byte swizzle, 8-row groups 1024 bytes apart. `addr` is 1024-byte
// aligned plus 32 bytes for each k16 step inside the swizzle span.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Byte offset of 16-byte group `group` (8 channels) of row `row` in a
// swizzled region: what TMA writes and what the descriptor reads.
__device__ __forceinline__ uint32_t sw128(int row, int group) {
  return static_cast<uint32_t>(row * kRowBytes + ((group ^ (row & 7)) << 4));
}

// d (64 x 64, f32) = a (64 x 16 bf16, shared, K-major) * b (16 x 64 bf16, shared, K-major) [+ d].
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with 32 columns.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with a's fragments in registers (this warp's 16 rows, as mma.sync's A).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// float32 weights [k][n] (n contiguous, K x N) to bf16 [k / 64][n / 64][64 n][64 k]
// swizzled chunks. A thread takes 8 consecutive k of one n: every load of a
// warp reads 128 contiguous bytes, and the 8 values leave as one 16-byte
// store whose swizzled address does the transpose.
__device__ void convert_kn(const float* __restrict__ src, int K, int N, unsigned char* dst, int tid,
                           int threads) {
  for (int u = tid; u < N * (K / 8); u += threads) {
    const int n = u % N, k0 = (u / N) * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __ldg(src + static_cast<size_t>(k0 + e) * N + n);
    unsigned char* chunk = dst + ((k0 / 64) * (N / 64) + n / 64) * kChunkBytes;
    *reinterpret_cast<uint4*>(chunk + sw128(n % 64, (k0 % 64) / 8)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// The packing kernel: a block's float32 weights in the JAX layout to the
// bytes the Hopper kernel keeps in shared memory ([w1, bars) of its layout,
// which does not depend on the tile), so that each of its blocks fetches
// them with three bulk copies instead of converting them again. Run once
// per set of weights; the wrapper keeps the result.
__global__ void pack_weights_kernel(Weights w, unsigned char* packed, int cin, int cout, Layout L) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  convert_kn(w.w1, cin, 64, packed, tid, threads);
  convert_kn(w.w2, 9 * 64, 64, packed + (L.w2 - L.w1), tid, threads);
  convert_kn(w.w3, 64, cout, packed + (L.w3 - L.w1), tid, threads);
  if (w.wd != nullptr) convert_kn(w.wd, 64, cout, packed + (L.wd - L.w1), tid, threads);
  float* f = reinterpret_cast<float*>(packed + (L.f - L.w1));
  for (int i = tid; i < 64; i += threads) {
    f[i] = w.s1[i];
    f[64 + i] = w.b1[i];
    f[128 + i] = w.s2[i];
    f[192 + i] = w.b2[i];
  }
  for (int i = tid; i < cout; i += threads) {
    f[256 + i] = w.s3[i];
    f[256 + cout + i] = w.b3[i];
    if (w.wd != nullptr) {
      f[256 + 2 * cout + i] = w.sd[i];
      f[256 + 3 * cout + i] = w.bd[i];
    }
  }
}

struct TileXY {
  int b, y0, x0;
};

template <int TH, int TW>
__device__ __forceinline__ TileXY tile_at(const Params& p, int tile) {
  const int per_img = p.tiles_y * p.tiles_x;
  const int b = tile / per_img;
  const int r = tile - b * per_img;
  return {b, (r / p.tiles_x) * TH, (r % p.tiles_x) * TW};
}

// Stage 1 over x chunks [kc_begin, kc_end) of one tile: waits for each ring
// slot, adds the chunk's product into acc1 (whole m tiles) and accr (this
// warpgroup's half of the odd one), and frees each slot once its product
// is done (the last one only if release_last). With RES the thread also
// takes, from chunk kc in the ring, x at its two output pixels and its 16
// channels of output chunk kc: the identity residual, which so never
// crosses device memory twice (res_off: the byte offsets of those two
// pixels' rows in a slot, t4: lane & 3). `it` counts the block's chunks:
// slot it % stages, parity (it / stages) & 1. The loop is unrolled over
// kMaxChunks so that res is indexed by constants.
template <int TH, int TW, bool RES, int NRES>
__device__ __forceinline__ void stage1_chunks(float (&acc1)[Tile<TH, TW>::kFull][32], float (&accr)[16],
                                              uint32_t (&res)[NRES][2][8], const int (&res_row)[2], int t4,
                                              int& it, int kc_begin, int kc_end, bool release_last,
                                              int stages, uint32_t full_bar, uint32_t empty_bar,
                                              uint32_t xs, uint32_t w1s, int group, int lane) {
  using TL = Tile<TH, TW>;
  if (kc_begin >= kc_end) return;
#pragma unroll
  for (int kc = 0; kc < kMaxChunks; ++kc) {
    if (kc < kc_begin || kc >= kc_end) continue;
    const int slot = it % stages;
    mbar_wait(full_bar + 8 * slot, (it / stages) & 1);
    const uint32_t xa_addr = xs + slot * TL::kStageBytes;
    const uint32_t wb_addr = w1s + kc * kChunkBytes;
    if constexpr (RES) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          res[kc][hh][j] = lds_u32(xa_addr + sw128(res_row[hh], j) + t4 * 4);
    }
    wgmma_fence();
#pragma unroll
    for (int f = 0; f < TL::kFull; ++f) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n64(acc1[f], sw128_desc(xa_addr + (group + f * TL::kGroups) * kChunkBytes + ks * 32),
                     sw128_desc(wb_addr + ks * 32), (kc | ks) != 0);
    }
    if constexpr (TL::kRem != 0) {  // the odd m tile: this warpgroup's 32 of the 64 columns
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n32(accr, sw128_desc(xa_addr + TL::kFull * TL::kGroups * kChunkBytes + ks * 32),
                     sw128_desc(wb_addr + group * 32 * kRowBytes + ks * 32), (kc | ks) != 0);
    }
    wgmma_commit();
    if (kc > kc_begin) {  // the chunk before this one has been read: its slot is free
      wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % stages));
    }
    ++it;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int f = 0; f < TL::kFull; ++f) pin(acc1[f]);
  if constexpr (TL::kRem != 0) pin(accr);
  if (release_last) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * ((it - 1) % stages));
  }
}

// Built with -DZSG_K3_CLOCKS (zsgnet_tpu_torch/tools/k3_stage_clocks.py) the
// first consumer thread of block 0 adds up clock64 between the marks below:
// cycles in 0 stage 1's second half, 1 h1's epilogue and its barriers, 2
// stage 2, 3 stage 3's first chunks, 4 the next tile's first half of stage
// 1, 5 the rest of stage 3; 6 the block's tiles. Not compiled otherwise.
#ifdef ZSG_K3_CLOCKS
__device__ long long zsg_k3_clocks[7];
#define ZSG_CLK(i)                \
  {                               \
    const long long t_ = clock64(); \
    clk[i] += t_ - t_last;        \
    t_last = t_;                  \
  }
#else
#define ZSG_CLK(i)
#endif

// T: x's and the output's type. TH x TW: the output tile. PROJ: projection
// residual (Cin 64) instead of the identity.
template <typename T, int TH, int TW, bool PROJ>
__global__ void __launch_bounds__(Tile<TH, TW>::kThreads, 1)
    bottleneck_wgmma_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap out_map) {
  using TL = Tile<TH, TW>;
  constexpr bool kTma = std::is_same<T, bf16>::value;
  constexpr int kHaloW = TL::kHaloW, kHaloPix = TL::kHaloPix, kGroups = TL::kGroups;
  constexpr int kFull = TL::kFull, kRem = TL::kRem;
  constexpr bool kRingRes = kTma && !PROJ;  // the identity residual taken from the x ring
  constexpr int kResChunks = kRingRes ? kMaxChunks : 1;
  constexpr bool kTmaOut = kTma;  // bf16 output through shared memory and TMA stores

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const Layout L = make_layout<TH, TW>(p.cin, p.cout, PROJ, p.stages);
  const uint32_t xs = base + L.x, hs = base + L.h;
  const uint32_t w1s = base + L.w1, w2s = base + L.w2, w3s = base + L.w3, wds = base + L.wd;
  const uint32_t full_bar = base + L.bars, empty_bar = full_bar + kMaxStages * 8;
  const uint32_t weight_bar = empty_bar + kMaxStages * 8;
  const float* s1 = reinterpret_cast<const float*>(smem + L.f);
  const float* b1 = s1 + 64;
  const float* s2 = b1 + 64;
  const float* b2 = s2 + 64;
  const float* s3 = b2 + 64;
  const float* b3 = s3 + p.cout;
  const float* sd = b3 + p.cout;
  const float* bd = sd + p.cout;

  const int tid = threadIdx.x;
  const int group = tid >> 7;  // warpgroup: 0 .. kGroups - 1 consume, kGroups produces
  const int stages = p.stages;
  const int kc_n = p.cin / 64;   // 64-channel chunks of x
  const int nc_n = p.cout / 64;  // and of the output
  const int my_tiles =
      static_cast<int>(blockIdx.x) < p.n_tiles ? (p.n_tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int my_chunks = my_tiles * kc_n;

  if (tid == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(full_bar + 8 * s, kTma ? 1 : 128);   // the TMA's issuer, or every converting thread
      mbar_init(empty_bar + 8 * s, kGroups * 4);     // one lane of each consumer warp
    }
    for (int s = 0; s < 3; ++s) mbar_init(weight_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const CUtensorMap* map_ptr = &x_map;
  const CUtensorMap* out_ptr = &out_map;
  // Chunk `it` of this block's sequence (tile it / kc_n, channels 64 * (it % kc_n)) by TMA.
  auto issue_tma = [&](int it) {
    const int slot = it % stages;
    const TileXY t = tile_at<TH, TW>(p, blockIdx.x + (it / kc_n) * gridDim.x);
    mbar_wait(empty_bar + 8 * slot, ((it / stages) & 1) ^ 1);  // passes at once on a slot's first use
    mbar_arrive_expect_tx(full_bar + 8 * slot, kHaloPix * kRowBytes);
    tma_load_4d(xs + slot * TL::kStageBytes, map_ptr, full_bar + 8 * slot, (it % kc_n) * 64, t.x0 - 1,
                t.y0 - 1, t.b);
  };
  // Weight prologue: one thread asks for the packed weights in three parts,
  // each with its own barrier, so stage 1 of the first tile waits for w1 and
  // the scales only; the first x chunks go out in between.
  int produced = 0;
  if (tid == TL::kConsumers) {
    const uint32_t w1_bytes = L.w2 - L.w1, w2_bytes = L.w3 - L.w2, w3_bytes = L.f - L.w3;
    const uint32_t f_bytes = L.bars - L.f;
    mbar_arrive_expect_tx(weight_bar, w1_bytes + f_bytes);
    bulk_load(w1s, p.packed, w1_bytes, weight_bar);
    bulk_load(base + L.f, p.packed + (L.f - L.w1), f_bytes, weight_bar);
    if constexpr (kTma) {
      for (; produced < min(my_chunks, stages); ++produced) issue_tma(produced);
    }
    mbar_arrive_expect_tx(weight_bar + 8, w2_bytes);
    bulk_load(w2s, p.packed + (L.w2 - L.w1), w2_bytes, weight_bar + 8);
    mbar_arrive_expect_tx(weight_bar + 16, w3_bytes);  // w3, and wd behind it
    bulk_load(w3s, p.packed + (L.w3 - L.w1), w3_bytes, weight_bar + 16);
  }

  if (group == kGroups) {
    // ===== Producer warpgroup: keeps the ring of x chunks full.
    // With two consumer warpgroups a thread starts with at most 168 registers:
    // the producer hands most of its own to them.
    if constexpr (kGroups == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if constexpr (kTma) {
      if (tid == TL::kConsumers) {
        for (; produced < my_chunks; ++produced) issue_tma(produced);
      }
    } else {
      // float32 x: load, convert and store the layout TMA would have written.
      const float* x = static_cast<const float*>(p.x);
      const int ptid = tid - TL::kConsumers;
      for (int it = 0; it < my_chunks; ++it) {
        const int slot = it % stages;
        const TileXY t = tile_at<TH, TW>(p, blockIdx.x + (it / kc_n) * gridDim.x);
        mbar_wait(empty_bar + 8 * slot, ((it / stages) & 1) ^ 1);
        unsigned char* dst = smem + L.x + slot * TL::kStageBytes;
        for (int i = ptid; i < kHaloPix * 8; i += 128) {
          const int q = i >> 3, c = i & 7;
          const int gy = t.y0 - 1 + q / kHaloW, gx = t.x0 - 1 + q % kHaloW;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
            const float* src =
                x + ((static_cast<size_t>(t.b) * p.H + gy) * p.W + gx) * p.cin + (it % kc_n) * 64 + c * 8;
            const float4 lo = *reinterpret_cast<const float4*>(src);
            const float4 hi = *reinterpret_cast<const float4*>(src + 4);
            v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                           pack_bf16(hi.z, hi.w));
          }
          *reinterpret_cast<uint4*>(dst + sw128(q, c)) = v;
        }
        fence_proxy_async();
        mbar_arrive(full_bar + 8 * slot);
      }
    }
  } else {
    // ===== Consumer warpgroups: one m64 tile of output pixels each.
    if constexpr (kGroups == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const T* x = static_cast<const T*>(p.x);
    T* out = static_cast<T*>(p.out);
    const int lane = tid & 31;
    const int wq = (tid >> 5) & 3;  // warp of the warpgroup: rows 16 * wq .. of an m64 tile
    const int g = lane >> 2, t4 = lane & 3;
    const int a_half = lane >> 4;  // ldmatrix: lanes 16.. address the k + 8 half
    const bool elected = (tid & 127) == 0;  // issues this warpgroup's TMA stores
    // This lane's ldmatrix row among the warpgroup's output pixels, as (y, x) in the tile.
    const int pa = group * 64 + wq * 16 + (lane & 15);
    const int pa_row = (pa / TW) * kHaloW + pa % TW;  // its halo row at tap (0, 0)
    // The two accumulator rows of this thread: (y, x) in the tile, the row
    // among the warpgroup's 64 pixels, and the halo row of the pixel itself.
    int ey[2], ex[2], own_row[2], res_row[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      own_row[hh] = wq * 16 + g + 8 * hh;
      const int pe = group * 64 + own_row[hh];
      ey[hh] = pe / TW;
      ex[hh] = pe % TW;
      res_row[hh] = (ey[hh] + 1) * kHaloW + ex[hh] + 1;
    }
    const uint32_t stage_out = hs + group * kChunkBytes;  // kTmaOut: 64 pixels x 64 channels, in h1's place

    // Stage 1 of a tile is split: its first x chunks are consumed early, in
    // the middle of stage 3 of the tile before, so that the chunks asked for
    // when their slots come free arrive behind the rest of stage 3, and those
    // asked for after the second half arrive behind stage 2. With a ring of
    // half a tile no stage then waits long for memory with nothing else to do.
    const int kc_split = kc_n / 2;
    float acc1[kFull][32];
    float accr[16];
    uint32_t xa[4][4];  // PROJ: x at this warp's 16 output pixels, A fragments of K = 64
    uint32_t res[kResChunks][2][8];  // kRingRes: the identity residual, bf16 pairs, from the ring
    int it = 0;                      // chunks consumed so far
#define ZSG_STAGE1(KC_BEGIN, KC_END, RELEASE_LAST)                                                     \
  stage1_chunks<TH, TW, kRingRes>(acc1, accr, res, res_row, t4, it, KC_BEGIN, KC_END, RELEASE_LAST,    \
                                  stages, full_bar, empty_bar, xs, w1s, group, lane)
    if (my_tiles > 0) {
      mbar_wait(weight_bar, 0);  // w1 and the scales
      ZSG_STAGE1(0, kc_split, true);
    } else {  // no tile (a prologue-only launch): the weights still land before the block ends
      for (int s = 0; s < 3; ++s) mbar_wait(weight_bar + 8 * s, 0);
    }
#ifdef ZSG_K3_CLOCKS
    long long clk[6] = {0, 0, 0, 0, 0, 0};
    long long t_last = clock64();
#endif
    for (int n = 0; n < my_tiles; ++n) {
      const TileXY tl = tile_at<TH, TW>(p, blockIdx.x + n * gridDim.x);

      // ---- Stage 1, second half: h1 over the halo tile, M = kM1 x 64, N = 64, K = Cin.
      ZSG_STAGE1(kc_split, kc_n, !PROJ);
      if constexpr (PROJ) {  // Cin is 64: the tile's one chunk holds all of x
        const int slot = (it - 1) % stages;
        const int rc = pa_row + kHaloW + 1;
        const uint32_t row_addr = xs + slot * TL::kStageBytes + rc * kRowBytes;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) ldsm_x4(row_addr + (((2 * ks + a_half) ^ (rc & 7)) << 4), xa[ks]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * slot);
      }
      ZSG_CLK(0)

      // Every warp has read the last tile's h1 (stage 2), and the last tile's
      // output has left its staging buffer, before this tile's h1 is written.
      if constexpr (kTmaOut) {
        if (elected) bulk_wait_read();
      }
      named_barrier(1, TL::kConsumers);
      // Row r of h1, channels 8 * col8 + 2 * t4 and the next, from accumulators a0 and a1.
      auto store_h1 = [&](int r, int col8, float a0, float a1) {
        if (r < kHaloPix) {
          const int gy = tl.y0 - 1 + r / kHaloW, gx = tl.x0 - 1 + r % kHaloW;
          const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
          const int c = col8 * 8 + 2 * t4;
          // Outside the image h1 is conv2's zero padding, not relu(b1).
          const float2 sc = *reinterpret_cast<const float2*>(s1 + c);
          const float2 bi = *reinterpret_cast<const float2*>(b1 + c);
          const float o0 = in ? fmaxf(a0 * sc.x + bi.x, 0.f) : 0.f;
          const float o1 = in ? fmaxf(a1 * sc.y + bi.y, 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(smem + L.h + sw128(r, col8) + t4 * 4) = pack_bf16(o0, o1);
        }
      };
#pragma unroll
      for (int f = 0; f < kFull; ++f) {
        const int row = (group + f * kGroups) * 64 + wq * 16 + g;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            store_h1(row + 8 * hh, j, acc1[f][4 * j + 2 * hh], acc1[f][4 * j + 2 * hh + 1]);
      }
      if constexpr (kRem != 0) {
        const int row = kFull * kGroups * 64 + wq * 16 + g;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            store_h1(row + 8 * hh, group * 4 + j, accr[4 * j + 2 * hh], accr[4 * j + 2 * hh + 1]);
      }
      named_barrier(1, TL::kConsumers);  // h1 is complete
      ZSG_CLK(1)

      // This thread's two output pixels.
      size_t pix[2];
      bool ok[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int gy = tl.y0 + ey[hh], gx = tl.x0 + ex[hh];
        ok[hh] = gy < p.H && gx < p.W;
        pix[hh] = (static_cast<size_t>(tl.b) * p.H + gy) * p.W + gx;
      }

      // ---- Stage 2: h2 at this warpgroup's 64 pixels, 9 taps x K = 64, N = 64. A from
      // registers: ldmatrix takes one row address per lane, so a tap's shift
      // is only an address offset (the tile's rows are runs of TW pixels one
      // halo row apart, which no shared-memory descriptor strides over).
      if (n == 0) mbar_wait(weight_bar + 8, 0);  // w2
      float acc2[32];
      {
        uint32_t a[2][4][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int r = pa_row + (tap / 3) * kHaloW + tap % 3;
          const uint32_t row_addr = hs + r * kRowBytes;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            ldsm_x4(row_addr + (((2 * ks + a_half) ^ (r & 7)) << 4), a[tap & 1][ks]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_rs_n64(acc2, a[tap & 1][ks], sw128_desc(w2s + tap * kChunkBytes + ks * 32), (tap | ks) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // the tap before this one is done: its fragments may be replaced
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (tap > 0) pin(a[(tap & 1) ^ 1][ks]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) pin(a[0][ks]);
        pin(acc2);
      }
      // Every warp has read h1: with kTmaOut its place now stages the output.
      if constexpr (kTmaOut) named_barrier(1, TL::kConsumers);

      // h2 = relu(s2 * acc + b2) rounded to bf16, straight into stage 3's A
      // fragments: the accumulator's layout is the A operand's.
      uint32_t a3[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * ks + half;
          const int c = j * 8 + 2 * t4;
          const float2 sc = *reinterpret_cast<const float2*>(s2 + c);
          const float2 bi = *reinterpret_cast<const float2*>(b2 + c);
          a3[ks][2 * half] =
              pack_bf16(fmaxf(acc2[4 * j] * sc.x + bi.x, 0.f), fmaxf(acc2[4 * j + 1] * sc.y + bi.y, 0.f));
          a3[ks][2 * half + 1] =
              pack_bf16(fmaxf(acc2[4 * j + 2] * sc.x + bi.x, 0.f), fmaxf(acc2[4 * j + 3] * sc.y + bi.y, 0.f));
        }
      }

      ZSG_CLK(2)

      // ---- Stage 3: y in chunks of 64 output channels, K = 64, plus the
      // projection (K = 64 on the x fragments) or the identity residual.
      // bf16 output leaves through shared memory and one TMA store per chunk
      // (whole 128-byte rows, the ragged edge clipped by the hardware);
      // float32 output is stored from the registers.
      if (n == 0) mbar_wait(weight_bar + 16, 0);  // w3, wd
      auto stage3_chunks = [&](int nc_begin, int nc_end) {
#pragma unroll
        for (int nc = 0; nc < kMaxChunks; ++nc) {
          if (nc < nc_begin || nc >= nc_end) continue;
          float2 late[2][8];
          if constexpr (!PROJ && !kRingRes) {  // float32 x: asked for before the product, used after it
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                late[hh][j] = ok[hh] ? load2<T>(x + pix[hh] * p.cin + nc * 64 + j * 8 + 2 * t4)
                                     : make_float2(0.f, 0.f);
          }
          float y[32], r[PROJ ? 32 : 1];
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_rs_n64(y, a3[ks], sw128_desc(w3s + nc * kChunkBytes + ks * 32), ks != 0);
          if constexpr (PROJ) {
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_rs_n64(r, xa[ks], sw128_desc(wds + nc * kChunkBytes + ks * 32), ks != 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          pin(y);
          if constexpr (PROJ) pin(r);
          uint32_t packed[2][8];  // kTmaOut: the chunk's outputs of this thread, as bf16 pairs
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (!kTmaOut && !ok[hh]) continue;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c = nc * 64 + j * 8 + 2 * t4;
              const float2 sc = *reinterpret_cast<const float2*>(s3 + c);
              const float2 bi = *reinterpret_cast<const float2*>(b3 + c);
              float v0 = y[4 * j + 2 * hh] * sc.x + bi.x;
              float v1 = y[4 * j + 2 * hh + 1] * sc.y + bi.y;
              if constexpr (PROJ) {
                const float2 scd = *reinterpret_cast<const float2*>(sd + c);
                const float2 bid = *reinterpret_cast<const float2*>(bd + c);
                v0 += r[4 * j + 2 * hh] * scd.x + bid.x;
                v1 += r[4 * j + 2 * hh + 1] * scd.y + bid.y;
              } else if constexpr (kRingRes) {  // bf16 pair: the low half is the first channel
                v0 += __uint_as_float(res[nc][hh][j] << 16);
                v1 += __uint_as_float(res[nc][hh][j] & 0xffff0000u);
              } else {
                v0 += late[hh][j].x;
                v1 += late[hh][j].y;
              }
              if constexpr (kTmaOut) {
                packed[hh][j] = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
              } else {
                store2<T>(out + pix[hh] * p.cout + c, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
              }
            }
          }
          if constexpr (kTmaOut) {  // once the chunk before this one has left the staging buffer
            if (elected) bulk_wait_read();
            named_barrier(2 + group, 128);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int j = 0; j < 8; ++j) sts_u32(stage_out + sw128(own_row[hh], j) + t4 * 4, packed[hh][j]);
          }
          if constexpr (kTmaOut) {
            fence_proxy_async();
            named_barrier(2 + group, 128);
            if (elected) {
              tma_store_4d(out_ptr, stage_out, nc * 64, tl.x0, tl.y0 + group * (64 / TW), tl.b);
              bulk_commit();
            }
          }
        }
      };
      // The next tile's first x chunks go between the two halves: the
      // residual registers of the output chunks already written are free for
      // the same chunks of the next tile.
      stage3_chunks(0, kc_split);
      ZSG_CLK(3)
      if (n + 1 < my_tiles) ZSG_STAGE1(0, kc_split, true);
      ZSG_CLK(4)
      stage3_chunks(kc_split, nc_n);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {  // stage 3 has read its fragments
        pin(a3[ks]);
        if constexpr (PROJ) pin(xa[ks]);
      }
      ZSG_CLK(5)
    }
#ifdef ZSG_K3_CLOCKS
    if (tid == 0 && blockIdx.x == 0) {
      for (int i = 0; i < 6; ++i) zsg_k3_clocks[i] = clk[i];
      zsg_k3_clocks[6] = my_tiles;
    }
#endif
#undef ZSG_STAGE1
    if constexpr (kTmaOut) {
      if (elected) bulk_wait_all();  // the block's shared memory outlives its last stores
    }
  }
}

// cuTensorMapEncodeTiled, looked up in the libcuda that the process has
// loaded already (the CUDA runtime library links none of its symbols).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                   CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A 4-D map over a bf16 (B, H, W, C) tensor with a box of 64 channels by
// box_w by box_h pixels and the 128-byte swizzle. Returns 0 or an error code.
int make_nhwc_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int box_h, int box_w) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2, static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                              box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 100000 + static_cast<int>(res);  // a CUresult, set apart from the runtime's codes
}

template <typename T, int TH, int TW, bool PROJ>
int launch(Params p, bool prologue_only, cudaStream_t stream) {
  using TL = Tile<TH, TW>;
  p.stages = stages_that_fit<TH, TW>(p.cin, p.cout, PROJ);
  if (p.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles_y = (p.H + TH - 1) / TH;
  p.tiles_x = (p.W + TW - 1) / TW;
  const long long n_tiles = static_cast<long long>(p.B) * p.tiles_y * p.tiles_x;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = static_cast<int>(n_tiles);
  // bf16: x comes in by halo tiles, the output leaves by one warpgroup's 64 pixels.
  CUtensorMap map = {}, out_map = {};
  if (std::is_same<T, bf16>::value) {
    int err = make_nhwc_map(&map, p.x, p.B, p.H, p.W, p.cin, TL::kHaloH, TL::kHaloW);
    if (err == 0) err = make_nhwc_map(&out_map, p.out, p.B, p.H, p.W, p.cout, 64 / TW, TW);
    if (err != 0) return err;
  }
  const int smem = make_layout<TH, TW>(p.cin, p.cout, PROJ, p.stages).bytes;
  auto kernel = bottleneck_wgmma_kernel<T, TH, TW, PROJ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = std::min(p.n_tiles, sms);  // persistent: one block on each SM
  if (prologue_only) p.n_tiles = 0;           // the same grid, no tile: the weight prologue alone
  kernel<<<grid, TL::kThreads, smem, stream>>>(p, map, out_map);
  return static_cast<int>(cudaGetLastError());
}

template <int TH, int TW>
int launch_tile(const Params& p, bool proj, bool x_is_bf16, bool prologue_only, cudaStream_t stream) {
  if (x_is_bf16)
    return proj ? launch<bf16, TH, TW, true>(p, prologue_only, stream)
                : launch<bf16, TH, TW, false>(p, prologue_only, stream);
  return proj ? launch<float, TH, TW, true>(p, prologue_only, stream)
              : launch<float, TH, TW, false>(p, prologue_only, stream);
}

// Bytes of the packed weights of a block of these widths.
int packed_bytes(int cin, int cout, bool proj) {
  const Layout L = make_layout<8, 8>(cin, cout, proj, 0);
  return L.bars - L.w1;
}

int launch_pack(const Weights& w, void* packed, int cin, int cout, cudaStream_t stream) {
  const Layout L = make_layout<8, 8>(cin, cout, w.wd != nullptr, 0);
  pack_weights_kernel<<<72, 256, 0, stream>>>(w, static_cast<unsigned char*>(packed), cin, cout, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// Which kernel takes a shape. The choice is made here, from the shape alone,
// before any launch: the wgmma kernel takes the widths it is built for
// (Cmid 64, Cin and Cout multiples of 64 up to 256, Cin 64 with a
// projection, and a ring of at least two x slots fitting in shared memory); everything else
// goes to the mma.sync kernel.
enum Variant { kAuto = 0, kMma = 1, kWgmma8x8 = 2, kWgmma8x16 = 3 };

bool wgmma_takes(int cin, int cmid, int cout, bool proj, int variant) {
  if (cmid != 64 || cin % 64 || cout % 64 || cin > 64 * wg::kMaxChunks || cout > 64 * wg::kMaxChunks ||
      (proj && cin != 64))
    return false;
  return variant == kWgmma8x8 ? wg::stages_that_fit<8, 8>(cin, cout, proj) > 0
                              : wg::stages_that_fit<8, 16>(cin, cout, proj) > 0;
}

// 8 x 16 tiles: the faster of the two instances at every shape measured.
int choose_variant(int cin, int cmid, int cout, bool proj) {
  return wgmma_takes(cin, cmid, cout, proj, kWgmma8x16) ? kWgmma8x16 : kMma;
}

}  // namespace

extern "C" {

// The kernel that zsg_bottleneck_infer launches for these widths: 1 the
// mma.sync kernel, 3 the wgmma kernel with 8 x 16 tiles (2, the same with
// 8 x 8 tiles, is launched only when asked for by name).
int zsg_bottleneck_variant(int cin, int cmid, int cout, int has_proj) {
  return choose_variant(cin, cmid, cout, has_proj != 0);
}

// Dynamic shared memory in bytes that one block of that kernel needs.
long long zsg_bottleneck_smem_bytes(int cin, int cmid, int cout, int has_proj) {
  const bool proj = has_proj != 0;
  if (choose_variant(cin, cmid, cout, proj) == kWgmma8x16)
    return wg::make_layout<8, 16>(cin, cout, proj, wg::stages_that_fit<8, 16>(cin, cout, proj)).bytes;
  return static_cast<long long>(make_layout(cin, padded_cmid(cmid), cout, proj).bytes);
}

// Largest dynamic shared memory a block may opt into on the current device (-1 on error).
int zsg_bottleneck_max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess) return -1;
  return bytes;
}

// K3 on `stream` with the kernel named by `variant` (0: chosen by shape, as
// zsg_bottleneck_variant says; 1-3: that kernel, or cudaErrorInvalidValue
// if it does not take the shape), so that one run can time the kernels side
// by side. The wgmma kernel reads its weights from `packed`
// (zsg_bottleneck_pack; the mma.sync kernel reads w1 .. bd and ignores it).
// prologue_only launches the wgmma kernel's grid over no tile: the weight
// prologue alone, writing nothing to out. out (B, H, W, Cout) in x's
// dtype (bf16 if x_is_bf16, else float32). wd, sd and bd are all null for
// the identity residual. Returns the CUDA error code of the launch (0 on
// success; 100000 + the CUresult if building a tensor map failed).
int zsg_bottleneck_infer_variant(const void* x, const void* w1, const void* s1, const void* b1,
                                 const void* w2, const void* s2, const void* b2, const void* w3,
                                 const void* s3, const void* b3, const void* wd, const void* sd,
                                 const void* bd, const void* packed, void* out, int batch, int height,
                                 int width, int cin, int cmid, int cout, int x_is_bf16, int variant,
                                 int prologue_only, void* stream) {
  const bool proj = wd != nullptr;
  if (batch <= 0 || height <= 0 || width <= 0 || cin <= 0 || cin % 16 || cout <= 0 || cout % 16 ||
      cmid <= 0 || cmid > 64 || (!proj && cin != cout) || (proj && (sd == nullptr || bd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == kAuto) variant = choose_variant(cin, cmid, cout, proj);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == kWgmma8x8 || variant == kWgmma8x16) {
    if (!wgmma_takes(cin, cmid, cout, proj, variant)) return static_cast<int>(cudaErrorInvalidValue);
    if (packed == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    wg::Params p;
    p.x = x;
    p.packed = static_cast<const unsigned char*>(packed);
    p.out = out;
    p.B = batch;
    p.H = height;
    p.W = width;
    p.cin = cin;
    p.cout = cout;
    return variant == kWgmma8x8 ? wg::launch_tile<8, 8>(p, proj, x_is_bf16 != 0, prologue_only != 0, s)
                                : wg::launch_tile<8, 16>(p, proj, x_is_bf16 != 0, prologue_only != 0, s);
  }
  if (variant != kMma || prologue_only) return static_cast<int>(cudaErrorInvalidValue);
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
  return x_is_bf16 ? dispatch_mma<bf16>(p, s) : dispatch_mma<float>(p, s);
}

// Bytes of the packed weights that the wgmma kernel reads for these widths.
long long zsg_bottleneck_packed_bytes(int cin, int cout, int has_proj) {
  return wg::packed_bytes(cin, cout, has_proj != 0);
}

// One launch of the packing kernel on `stream`: float32 weights in the JAX
// layout (wd, sd, bd null without a projection) to `packed`, for widths that
// the wgmma kernel takes. Returns the CUDA error code of the launch.
int zsg_bottleneck_pack(const void* w1, const void* s1, const void* b1, const void* w2, const void* s2,
                        const void* b2, const void* w3, const void* s3, const void* b3, const void* wd,
                        const void* sd, const void* bd, void* packed, int cin, int cmid, int cout,
                        void* stream) {
  if (packed == nullptr || !wgmma_takes(cin, cmid, cout, wd != nullptr, kWgmma8x8))
    return static_cast<int>(cudaErrorInvalidValue);
  const wg::Weights w{static_cast<const float*>(w1), static_cast<const float*>(s1), static_cast<const float*>(b1),
                      static_cast<const float*>(w2), static_cast<const float*>(s2), static_cast<const float*>(b2),
                      static_cast<const float*>(w3), static_cast<const float*>(s3), static_cast<const float*>(b3),
                      static_cast<const float*>(wd), static_cast<const float*>(sd), static_cast<const float*>(bd)};
  return wg::launch_pack(w, packed, cin, cout, static_cast<cudaStream_t>(stream));
}

#ifdef ZSG_K3_CLOCKS
// The last wgmma launch's cycle counts (7 values, see ZSG_CLK) to the host.
int zsg_bottleneck_read_clocks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, wg::zsg_k3_clocks, sizeof(long long) * 7));
}
#endif

// K3 on `stream`, the kernel chosen by shape: what the package calls.
int zsg_bottleneck_infer(const void* x, const void* w1, const void* s1, const void* b1, const void* w2,
                         const void* s2, const void* b2, const void* w3, const void* s3, const void* b3,
                         const void* wd, const void* sd, const void* bd, const void* packed, void* out,
                         int batch, int height, int width, int cin, int cmid, int cout, int x_is_bf16,
                         void* stream) {
  return zsg_bottleneck_infer_variant(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, wd, sd, bd, packed, out, batch,
                                      height, width, cin, cmid, cout, x_is_bf16, kAuto, 0, stream);
}

}  // extern "C"
