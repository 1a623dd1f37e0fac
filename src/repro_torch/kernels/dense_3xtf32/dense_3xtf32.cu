// Dense fp32 products y = x w of a prefill on the H100's tensor cores at
// fp32 accuracy (3xTF32).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (jnp.einsum in src/repro/models/attention.py and mlp.py).  The port ran
// them as torch.einsum, which with TF32 off is cuBLAS's fp32 SIMT GEMM on
// the H100 (67 TFLOP/s at most).  This kernel takes the products of a
// prefill that the routing function (ops.py) sends it: q, k and v of a
// layer in one launch, the attention output projection, the MLP's two
// products, an MoE layer's shared experts.
//
// Bound on an H100: operations.  yi-9b's 1,024-row products do 2 M K N
// flops against (M K + K N + M N) x 4 bytes moved once: the MLP's wi
// 184.7 GFLOP per 467 MB, about 400 FLOP a byte.  Every product runs in
// 3xTF32: x_lo w_hi + x_hi w_lo + x_hi w_hi summed in fp32 (x_lo w_lo
// dropped), three TF32 products at 495 TFLOP/s, so 165 TFLOP/s of fp32
// work at best.  The split: a weight's high part is the weight rounded to
// nearest TF32 (Veltkamp's split: three fp32 operations), its low part the
// exact remainder; x's high part is its TF32 truncation, which the tensor
// cores read from x itself, its low part the remainder rounded to nearest.
// The tensor cores' own fp32 sums truncate (a 4,096-deep sum of 3 x 512
// MMAs into one accumulator lost 2.9e-5 of the result, 25 times cuBLAS's
// error), so each 32-deep stage sums into a fresh accumulator and the
// stages are summed in fp32 registers, rounded to nearest: 2.7e-7 at
// yi-9b's widths against cuBLAS's 4e-7 to 1.1e-6.
//
// Design: warpgroup MMAs (wgmma.m64nNk8.tf32), computed transposed,
// y^T = w^T x^T, because a TF32 wgmma reads its shared-memory operand only
// K-major: x [M, K] is K-major as it lies, the weight [K, N] is not, so
// the weight is the register operand A, which the threads load in any
// order.
// - A block owns 128 weight columns and BT tokens (64 or 128, the MMA's
//   N); the grid runs the token tiles fastest, so the blocks in flight
//   share their weight columns in L2 and the whole of x stays there.
// - Warp-specialised, 384 threads.  A producer warpgroup (40 registers)
//   copies x's 32-deep tiles into a ring of 4 stages with cp.async, 16
//   bytes a thread, into the 128-byte swizzle that the MMA's descriptor
//   names (a row of 32 floats, 8 rows to a 1,024-byte atom), and writes
//   each tile's x_lo beside it in the same layout, one stage behind its
//   copies: a tile is read from device memory once.  Two consumer
//   warpgroups (232 registers) own 64 weight columns each: each thread
//   loads its A fragments of the weight straight from device memory one
//   stage ahead, splits them in registers, and issues a stage's 12 MMAs
//   (per 8-deep step the two cross terms, then the four hi.hi products,
//   as ssd_scan.cu's mma3 orders them).  Barriers in shared memory pass
//   the ring between them: full (the producer's 128 threads have split a
//   stage) and empty (the consumers' MMAs on it are done).  A consumer
//   waits for its previous stage's MMAs only after it has split and
//   loaded the next weights; the two consumers run apart, so one's MMAs
//   fill the other's waits.
// - q, k and v in one launch: up to three weights with their own outputs
//   share x, their column tiles laid end to end on the grid.
// Layouts: x [M, K] and each weight [K, N] row-major and contiguous, K and
// N multiples of 4 (16-byte copies); tiles past M, K or N are zero-filled
// and not stored.
//
// C interface (ctypes): dense_3xtf32 returns a cudaError_t as int, 0 on
// success; one launch on the caller's stream, unsynchronised.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;  // a producer warpgroup, two consumers
constexpr int kBK = 32;        // depth of a stage: one 128-byte row of x
constexpr int kBN = 128;       // weight columns a block
constexpr int kStages = 4;
constexpr int kMaxSegs = 3;

struct Segs {
  const float* w[kMaxSegs];
  float* y[kMaxSegs];
  int n[kMaxSegs];
  int tiles[kMaxSegs];  // column tiles of each weight
  int count;
};

template <int BT>
struct Layout {
  static constexpr int x_bytes = BT * kBK * 4;  // a multiple of 1,024
  static constexpr int lo_offset = kStages * x_bytes;
  static constexpr int bar_offset = 2 * kStages * x_bytes;  // full, empty
  static constexpr int smem_bytes = bar_offset + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to nearest TF32 (Veltkamp's split at 11 bits: three fp32
// operations, kept from contraction)
__device__ __forceinline__ float tf32_round(float x) {
  const float t = __fmul_rn(x, 8193.0f);
  return __fsub_rn(t, __fsub_rn(t, x));
}

// a weight w = hi + lo: hi w rounded to nearest TF32, lo the exact
// remainder, of which the tensor cores read the top 11 bits
__device__ __forceinline__ void split_w(float w, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_round(w);
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(w, h));
}

// x's low part: x - hi rounded to nearest TF32, hi the TF32 truncation of
// x that the tensor cores read from x itself
__device__ __forceinline__ uint32_t x_lo(float x) {
  const float hi = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __float_as_uint(tf32_round(__fsub_rn(x, hi)));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// the producer warpgroup's own barrier (id 1; __syncthreads is 0)
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// 8-row atoms of 1,024 bytes (SBO), start 16-byte aligned
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= uint64_t(16 >> 4) << 16;    // LBO: unused by a swizzled K-major tile
  d |= uint64_t(1024 >> 4) << 32;  // SBO
  d |= uint64_t(1) << 62;          // 128-byte swizzle
  return d;
}

// acc[64 x N] = A[64 x 8] B[8 x N] + (scale_d ? acc : 0): A in registers
// (TF32 bits, the mma.sync m16n8k8 A fragment per warp), B through its
// descriptor
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the weight of a block's column tile, its tiles laid end to end
__device__ __forceinline__ int seg_of(const Segs& s, int& tile) {
  int i = 0;
  while (i + 1 < s.count && tile >= s.tiles[i]) {
    tile -= s.tiles[i];
    ++i;
  }
  return i;
}

// stage kt of x's [BT, 32] tile into ring buffer buf, in the 128-byte
// swizzle
template <int BT>
__device__ __forceinline__ void load_x(uint32_t sbase, int buf, int kt,
                                       const float* x, int M, int K,
                                       int t0) {
  const int k0 = kt * kBK;
  const uint32_t xs = sbase + buf * Layout<BT>::x_bytes;
#pragma unroll
  for (int i = 0; i < BT * 8 / 128; ++i) {
    const int c = threadIdx.x + i * 128;
    const int r = c >> 3, ch = c & 7;
    const int t = t0 + r, k = k0 + ch * 4;
    const bool ok = t < M && k < K;
    cp_async16(xs + r * 128 + ((ch ^ (r & 7)) << 4),
               ok ? x + size_t(t) * K + k : x, ok);
  }
}

// x_lo of ring buffer buf's tile into lo buffer buf, in the same layout
template <int BT>
__device__ __forceinline__ void split_x(uint8_t* smem, int buf) {
  using L = Layout<BT>;
  const float4* xs = reinterpret_cast<const float4*>(smem + buf * L::x_bytes);
  uint4* lo = reinterpret_cast<uint4*>(smem + L::lo_offset +
                                       buf * L::x_bytes);
#pragma unroll
  for (int i = 0; i < BT * 8 / 128; ++i) {
    const int c = threadIdx.x + i * 128;
    const float4 v = xs[c];
    lo[c] = make_uint4(x_lo(v.x), x_lo(v.y), x_lo(v.z), x_lo(v.w));
  }
}

// the thread's weights of stage kt, straight from device memory: for each
// 8-deep step j its A fragment, A(row, k) = w[k][row] at rows fcol and
// fcol + 8 (weight columns), depths tig and tig + 4; zero past K and N
__device__ __forceinline__ void load_w(const float* __restrict__ w, int K,
                                       int N, int kt, int fcol, int tig,
                                       float (&wn)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = kt * kBK + 8 * j + tig + 4 * e;
      const float* p = w + size_t(k) * N + fcol;
      wn[j][2 * e] = k < K && fcol < N ? __ldg(p) : 0.f;
      wn[j][2 * e + 1] = k < K && fcol + 8 < N ? __ldg(p + 8) : 0.f;
    }
}

// registers an in-flight MMA reads stay live and unmoved up to here
__device__ __forceinline__ void keep(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[j][e])::"memory");
}

struct Tile {
  const float* x;
  const float* w;
  int M, K, N, t0, f0, fcol, KT;
};

// the producer warpgroup: copies x's tiles into the ring (cp.async, 16
// bytes a thread) and writes each tile's x_lo beside it, one stage behind
// its copies; a stage's full barrier completes when all 128 have split it
template <int BT>
__device__ __forceinline__ void produce(const Tile& tl, uint8_t* smem,
                                        uint32_t sbase, uint32_t full,
                                        uint32_t empty) {
  for (int kt = 0; kt <= tl.KT; ++kt) {
    if (kt < tl.KT) {
      const int buf = kt % kStages;
      if (kt >= kStages) mbar_wait(empty + 8 * buf, (kt / kStages - 1) & 1);
      load_x<BT>(sbase, buf, kt, tl.x, tl.M, tl.K, tl.t0);
    }
    cp_async_commit();
    if (kt == 0) continue;
    const int buf = (kt - 1) % kStages;
    cp_async_wait<1>();
    fence_proxy_async();
    producer_sync();
    split_x<BT>(smem, buf);
    fence_proxy_async();
    mbar_arrive(full + 8 * buf);
  }
}

// a consumer warpgroup's stage kt: split the weights loaded during stage
// kt - 1 into (ah, al) and load stage kt + 1's; wait for the stage's x and
// x_lo; wait for the MMAs issued before, which read (ph, pl), add their
// sum tc into acc and release their stage; issue stage kt's 12 MMAs into
// tc afresh: the two cross terms of every 8-deep step, then the four
// hi.hi products
template <int BT>
__device__ __forceinline__ void stage_step(
    int kt, const Tile& tl, uint32_t sbase, uint32_t full, uint32_t empty,
    float (&acc)[BT / 2], float (&tc)[BT / 2], float (&wn)[4][4], int tig,
    uint32_t (&ah)[4][4], uint32_t (&al)[4][4], uint32_t (&ph)[4][4],
    uint32_t (&pl)[4][4]) {
  using L = Layout<BT>;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_w(wn[j][e], ah[j][e], al[j][e]);
  if (kt + 1 < tl.KT) load_w(tl.w, tl.K, tl.N, kt + 1, tl.fcol, tig, wn);
  const int buf = kt % kStages;
  mbar_wait(full + 8 * buf, (kt / kStages) & 1);
  wgmma_wait<0>();
  keep(ph);
  keep(pl);
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] += tc[i];
  if (kt > 0) mbar_arrive(empty + 8 * ((kt - 1) % kStages));
  const uint32_t xb = sbase + buf * L::x_bytes;
  const uint32_t lb = sbase + L::lo_offset + buf * L::x_bytes;
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_tf32(tc, al[j], desc_sw128(xb + 32 * j), j > 0);
    wgmma_tf32(tc, ah[j], desc_sw128(lb + 32 * j), 1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_tf32(tc, ah[j], desc_sw128(xb + 32 * j), 1);
  wgmma_commit();
}

template <int BT>
__device__ __forceinline__ void consume(Tile& tl, uint32_t sbase,
                                        uint32_t full, uint32_t empty,
                                        float* y) {
  const int warp = (threadIdx.x >> 5) - 4, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  // this thread's weight column (MMA row): two warpgroups of 64 columns,
  // 16 a warp
  tl.fcol = tl.f0 + 64 * (warp >> 2) + 16 * (warp & 3) + gid;

  // acc: the fp32 sum of the stages, rounded to nearest; tc: one stage's
  // MMAs (the tensor cores' own sums truncate, so they sum 32 deep only)
  float acc[BT / 2], tc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = tc[i] = 0.f;
  uint32_t ah0[4][4] = {}, al0[4][4] = {}, ah1[4][4] = {}, al1[4][4] = {};
  float wn[4][4];
  load_w(tl.w, tl.K, tl.N, 0, tl.fcol, tig, wn);
  for (int kt = 0; kt < tl.KT; kt += 2) {
    stage_step<BT>(kt, tl, sbase, full, empty, acc, tc, wn, tig, ah0, al0,
                   ah1, al1);
    if (kt + 1 < tl.KT)
      stage_step<BT>(kt + 1, tl, sbase, full, empty, acc, tc, wn, tig, ah1,
                     al1, ah0, al0);
  }
  wgmma_wait<0>();
  keep(ah0);
  keep(al0);
  keep(ah1);
  keep(al1);
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] += tc[i];

  // acc[4 j + e]: column f (+ 8 for e >= 2) of tokens t, t + 1 (e odd)
  const int f = tl.fcol;
  const int M = tl.M, N = tl.N;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const int t = tl.t0 + 8 * j + 2 * tig;
    if (t < M) {
      if (f < N) y[size_t(t) * N + f] = acc[4 * j];
      if (f + 8 < N) y[size_t(t) * N + f + 8] = acc[4 * j + 2];
    }
    if (t + 1 < M) {
      if (f < N) y[size_t(t + 1) * N + f] = acc[4 * j + 1];
      if (f + 8 < N) y[size_t(t + 1) * N + f + 8] = acc[4 * j + 3];
    }
  }
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
    dense_wgmma_kernel(const float* __restrict__ x, int M, int K, Segs segs) {
  using L = Layout<BT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  const uint32_t full = sbase + L::bar_offset;
  const uint32_t empty = full + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + 8 * i, 128);
      mbar_init(empty + 8 * i, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int tile = blockIdx.y;
  const int s = seg_of(segs, tile);
  Tile tl;
  tl.x = x;
  tl.w = s == 0 ? segs.w[0] : s == 1 ? segs.w[1] : segs.w[2];
  float* y = s == 0 ? segs.y[0] : s == 1 ? segs.y[1] : segs.y[2];
  tl.N = s == 0 ? segs.n[0] : s == 1 ? segs.n[1] : segs.n[2];
  tl.M = M;
  tl.K = K;
  tl.t0 = blockIdx.x * BT;
  tl.f0 = tile * kBN;
  tl.KT = (K + kBK - 1) / kBK;
  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    produce<BT>(tl, smem, sbase, full, empty);
  } else {
    setmaxnreg_inc<232>();
    consume<BT>(tl, sbase, full, empty, y);
  }
}

template <int BT>
cudaError_t launch_wgmma(const float* x, int M, int K, const Segs& segs,
                         int tiles, cudaStream_t s) {
  const int smem = Layout<BT>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      dense_wgmma_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dense_wgmma_kernel<BT>
      <<<dim3((M + BT - 1) / BT, tiles), kThreads, smem, s>>>(x, M, K, segs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K]; count (1 to 3) weights w_i [K, n_i] with outputs y_i [M, n_i],
// all float32, row-major and contiguous; K and each n_i multiples of 4.
// variant 0: 64-token tiles; 1: 128-token tiles.
int dense_3xtf32(const float* x, int M, int K, int count, const float* w0,
                 const float* w1, const float* w2, int n0, int n1, int n2,
                 float* y0, float* y1, float* y2, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Segs segs;
  segs.w[0] = w0;
  segs.w[1] = w1;
  segs.w[2] = w2;
  segs.y[0] = y0;
  segs.y[1] = y1;
  segs.y[2] = y2;
  segs.n[0] = n0;
  segs.n[1] = n1;
  segs.n[2] = n2;
  segs.count = count;
  int tiles = 0;
  for (int i = 0; i < kMaxSegs; ++i) {
    segs.tiles[i] = i < count ? (segs.n[i] + kBN - 1) / kBN : 0;
    tiles += segs.tiles[i];
  }
  if (M <= 0 || tiles == 0) return 0;
  return static_cast<int>(variant == 0
                              ? launch_wgmma<64>(x, M, K, segs, tiles, s)
                              : launch_wgmma<128>(x, M, K, segs, tiles, s));
}

const char* dense_3xtf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
