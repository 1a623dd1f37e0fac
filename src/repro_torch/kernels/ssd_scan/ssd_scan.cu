// Mamba2 chunked SSD scan (state-space duality) from a zero state, on
// tensor cores at fp32 accuracy (3xTF32).
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py::ssd_scan_pallas (the
// TPU kernel: grid (batch, heads, chunks), the chunk axis sequential, the
// running [hd, S] state in VMEM scratch).  Its oracle is
// src/repro/models/ssm.py::ssd_chunked.
//
// For each (batch b, head h) and each chunk of Q steps, in order, with
// acs = cumsum(a) over the chunk and g = h / (nh / G) the head's group:
//   M[i, j] = exp(acs_i - acs_j) * (C_i . B_j)       for j <= i, else 0
//   y       = M X + (C * exp(acs)) state^T
//   state'  = exp(acs_{Q-1}) state + X^T (exp(acs_{Q-1} - acs) * B)
// where X [Q, hd] is the chunk's dt-scaled input of head h and B, C
// [Q, S] those of group g.  y of a chunk reads the state entering it;
// the update follows.  The recurrence is exact under any chunking, so a
// chunk longer than 64 is run as two pieces (only rounding changes).
//
// Bound on an H100: operations.  The products are C.B^T once per group
// and chunk (lower triangle), and per head M.X, C.state^T and X^T.B,
// about Q*S*hd multiply-adds each, against X, y and the state moving
// once: at mamba2-2.7b's prefill (b 1, s 2048, nh 80, hd 64, G 1, S 128,
// Q 64) 6.07 GFLOP per 89 MB.  Every product runs on the tensor cores in
// 3xTF32: a = a_hi + a_lo, a_hi the TF32 truncation of a and a_lo that of
// the remainder, and a_hi*b_lo + a_lo*b_hi + a_hi*b_hi accumulated in
// fp32 by mma.sync.m16n8k8 (1xTF32 keeps about three decimal digits, too
// few for 64 layers).  The least time is then 3 x 6.07 GFLOP at 495
// TFLOP/s dense TF32, about 37 us, above the 27 us the bytes take.
//
// Design: two kernels.
// - ssd_cb_kernel: C.B^T of every chunk of every group, lower-triangle
//   tiles only, into fp32 scratch (512 KB at the path's shape), since it
//   depends on neither the head nor the state.  One block per (chunk,
//   group, batch).
// - ssd_scan_kernel: the hd columns of a head are split into KS slices
//   (KS = 2 when hd is a multiple of 16), so b * nh * KS blocks (160 at
//   batch 1) each walk the chunks in order and keep their [hd / KS, S]
//   slice of the state in registers (as the accumulators of the state
//   update) and in shared memory (as an operand of C.state^T) for the
//   whole sequence: no state goes to HBM between chunks, which is the
//   TPU kernel's own point.  Per chunk: the update and the inter-chunk
//   term exp(acs) * (C state^T) in registers, then M X, with M formed
//   from C.B^T and the decays as its fragments are loaded.  B, C and a
//   of the next chunk are copied with cp.async as soon as the update and
//   C state^T are done with them, X and C.B^T after y; one warp per row,
//   16 bytes a lane.
// - Layout: shared-memory rows are padded (B, C and the state to S + 4
//   floats, C.B^T to Q + 4, X to hd / KS + 8) so that the mma fragment
//   loads are free of bank conflicts, except the B operand of the state
//   update (2-way).  8 warps per block, 110 KB at the path's shape, two
//   blocks per SM.  exp is only taken of acs_i - acs_j for j <= i (<= 0).
// What still holds it (PERF.md): per chunk every block copies about
// 88 KB (B, C, C.B^T, X), most of it the same for all heads of a group,
// and the warps that issue those cp.async wait on them; the tensor-core
// phases in between run with 8 to 16 warps per SM to hide their
// latency.  Copies issued ahead by the copy engine and shared by the
// blocks of a group are the next step.
//
// C interface (ctypes): ssd_scan_f32 returns a cudaError_t as int, 0 on
// success; the launches go to the caller's stream, unsynchronised.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCbThreads = 128;
constexpr int kMaxDim = 128;
constexpr int kMaxChunk = 64;  // longest chunk run in one piece

__device__ __forceinline__ int up(int x, int m) { return (x + m - 1) / m * m; }

// x = hi + lo with hi its TF32 truncation (the top 19 bits) and lo the
// exact remainder, itself truncated to TF32: three instructions, and
// together about 21 bits of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[u] += A B_u over k in [0, K) for the NT 8-column tiles u of one
// 16-row tile, in 3xTF32: a_hi b_hi accumulates in acc and each cross
// term in a chain of its own (three independent mma chains per tile),
// summed at the end.  load_a(k0, hi, lo) and load_b(u, k0, hi, lo) fetch
// and split the fragments; load_b returns false for a tile past the
// operand's edge.
template <int NT, class LoadA, class LoadB>
__device__ __forceinline__ void tile_mma(float acc[NT][4], int K,
                                         LoadA load_a, LoadB load_b) {
  float s1[NT][4] = {};
  float s2[NT][4] = {};
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a(k0, ah, al);
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      uint32_t bh[2], bl[2];
      if (!load_b(u, k0, bh, bl)) continue;
      mma_tf32(s1[u], al, bh);
      mma_tf32(s2[u], ah, bl);
      mma_tf32(acc[u], ah, bh);
    }
  }
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] += s1[u][e] + s2[u][e];
}

// A fragment (16 x 8, row-major) of tile rows r0.., columns k0..: element
// (row, col) at p[row * ld + col]
__device__ __forceinline__ void load_a(const float* p, int ld, int r0,
                                       int k0, int gid, int tig,
                                       uint32_t ah[4], uint32_t al[4]) {
  split_tf32(p[(r0 + gid) * ld + k0 + tig], ah[0], al[0]);
  split_tf32(p[(r0 + gid + 8) * ld + k0 + tig], ah[1], al[1]);
  split_tf32(p[(r0 + gid) * ld + k0 + tig + 4], ah[2], al[2]);
  split_tf32(p[(r0 + gid + 8) * ld + k0 + tig + 4], ah[3], al[3]);
}

// A fragment whose element (row, col) sits at p[col * ld + row]
__device__ __forceinline__ void load_a_t(const float* p, int ld, int r0,
                                         int k0, int gid, int tig,
                                         uint32_t ah[4], uint32_t al[4]) {
  split_tf32(p[(k0 + tig) * ld + r0 + gid], ah[0], al[0]);
  split_tf32(p[(k0 + tig) * ld + r0 + gid + 8], ah[1], al[1]);
  split_tf32(p[(k0 + tig + 4) * ld + r0 + gid], ah[2], al[2]);
  split_tf32(p[(k0 + tig + 4) * ld + r0 + gid + 8], ah[3], al[3]);
}

// B fragment (8 x 8) whose element (k, n) sits at p[n * ld + k]
__device__ __forceinline__ void load_b_nk(const float* p, int ld, int n0,
                                          int k0, int gid, int tig,
                                          uint32_t bh[2], uint32_t bl[2]) {
  split_tf32(p[(n0 + gid) * ld + k0 + tig], bh[0], bl[0]);
  split_tf32(p[(n0 + gid) * ld + k0 + tig + 4], bh[1], bl[1]);
}

// B fragment whose element (k, n) sits at p[k * ld + n]
__device__ __forceinline__ void load_b_kn(const float* p, int ld, int n0,
                                          int k0, int gid, int tig,
                                          uint32_t bh[2], uint32_t bl[2]) {
  split_tf32(p[(k0 + tig) * ld + n0 + gid], bh[0], bl[0]);
  split_tf32(p[(k0 + tig + 4) * ld + n0 + gid], bh[1], bl[1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, rows) of n floats each, from src + t * stride to dst + t * ld,
// a warp of W per row (16 bytes a lane where rows allow, else 4), or per
// 32 / (n / 4) rows when they are short, since every cp.async costs the
// warp that issues it; rows [rows, zero_to) are zeroed (the ragged end of
// the sequence)
template <int W>
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, int64_t stride,
                                          int rows, int zero_to, int n,
                                          bool vec, int warp, int lane) {
  if (vec && n < 128) {  // short rows: one instruction covers several
    const int per_row = n / 4;
    const int rpi = 32 / per_row;
    const int lr = lane / per_row;
    const int lc = lane - lr * per_row;
    if (lr < rpi)
      for (int t = warp * rpi + lr; t < rows; t += W * rpi)
        cp_async16(dst + t * ld + 4 * lc, src + t * stride + 4 * lc);
  } else if (vec) {
    for (int t = warp; t < rows; t += W)
      for (int c = 4 * lane; c < n; c += 128)
        cp_async16(dst + t * ld + c, src + t * stride + c);
  } else {
    for (int t = warp; t < rows; t += W)
      for (int c = lane; c < n; c += 32)
        cp_async4(dst + t * ld + c, src + t * stride + c);
  }
  for (int t = rows + warp; t < zero_to; t += W)
    for (int c = lane; c < n; c += 32) dst[t * ld + c] = 0.f;
}

// a[t] for t in [0, rows) from src + t * stride, one lane per step;
// [rows, zero_to) zeroed
__device__ __forceinline__ void copy_steps(float* dst, const float* src,
                                           int64_t stride, int rows,
                                           int zero_to, int tid) {
  for (int t = tid; t < zero_to; t += kThreads) {
    if (t < rows)
      cp_async4(dst + t, src + t * stride);
    else
      dst[t] = 0.f;
  }
}

// C.B^T of one piece of Qk steps of one group: the lower-triangle tiles
// (row tile mt, 16-column pairs pr <= mt) of a [QP, QP] fp32 block of cb.
__global__ void __launch_bounds__(kCbThreads)
    ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ cb, int s, int G, int S, int Qk) {
  extern __shared__ __align__(16) float smem[];
  const int ci = blockIdx.x;
  const int grp = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int QP = up(Qk, 16);
  const int SP = up(S, 8);
  const int ldb = SP + 4;
  float* Bs = smem;           // [QP, ldb]
  float* Cs = Bs + QP * ldb;  // [QP, ldb]
  for (int i = tid; i < 2 * QP * ldb; i += kCbThreads) smem[i] = 0.f;
  __syncthreads();
  const int64_t t0 = static_cast<int64_t>(bb) * s +
                     static_cast<int64_t>(ci) * Qk;
  const int rows = min(Qk, s - ci * Qk);
  const int64_t brow = static_cast<int64_t>(G) * S;
  const bool vec = S % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(Bm) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(Cm) & 15) == 0;
  copy_rows<kCbThreads / 32>(Bs, ldb, Bm + t0 * brow + grp * S, brow, rows,
                             rows, S, vec, warp, lane);
  copy_rows<kCbThreads / 32>(Cs, ldb, Cm + t0 * brow + grp * S, brow, rows,
                             rows, S, vec, warp, lane);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int n_chunks = (s + Qk - 1) / Qk;
  float* out = cb + ((static_cast<int64_t>(bb) * n_chunks + ci) * G + grp) *
                        QP * QP;
  int it = 0;
  for (int mt = 0; mt < QP / 16; ++mt) {
    for (int pr = 0; pr <= mt; ++pr, ++it) {
      if (it % (kCbThreads / 32) != warp) continue;
      float acc[2][4] = {};
      tile_mma<2>(
          acc, SP,
          [&](int k0, uint32_t* ah, uint32_t* al) {
            load_a(Cs, ldb, 16 * mt, k0, gid, tig, ah, al);
          },
          [&](int u, int k0, uint32_t* bh, uint32_t* bl) {
            load_b_nk(Bs, ldb, 16 * pr + 8 * u, k0, gid, tig, bh, bl);
            return true;
          });
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * mt + gid + 8 * half;
          const int j = 16 * pr + 8 * u + 2 * tig;
          *reinterpret_cast<float2*>(out + i * QP + j) =
              make_float2(acc[u][2 * half], acc[u][2 * half + 1]);
        }
    }
  }
}

// NI: items per warp of each phase (a 16 x 32 block of the state, a
// 16 x 16 block of y).
template <int NI>
__global__ void __launch_bounds__(kThreads, NI <= 2 ? 2 : 1)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ cb, float* __restrict__ y,
                    float* __restrict__ state_out, int s, int nh, int hd,
                    int G, int S, int Qk, int ks) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x / ks;
  const int rank = blockIdx.x - h * ks;
  const int bb = blockIdx.y;
  const int grp = h / (nh / G);
  const int P = hd / ks;
  const int p0 = rank * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  const int QP = up(Qk, 16);
  const int SP = up(S, 8);
  const int PP = up(P, 16);
  const int ldb = SP + 4;  // B, C, state rows
  const int ldx = PP + 8;  // X rows
  const int ldm = QP + 4;  // C.B^T rows
  float* Bs = smem;             // [QP, ldb]
  float* Cs = Bs + QP * ldb;    // [QP, ldb]
  float* Xs = Cs + QP * ldb;    // [QP, ldx]
  float* Ms = Xs + QP * ldx;    // [QP, ldm] C.B^T of the chunk's group
  float* St = Ms + QP * ldm;    // [PP, ldb]
  float* as = St + PP * ldb;    // [QP] a of the chunk
  float* acs = as + QP;         // [QP] cumsum
  float* ea = acs + QP;         // [QP] exp(acs)
  float* dte = ea + QP;         // [QP] exp(acs_end - acs)
  const int total = 2 * QP * ldb + QP * ldx + QP * ldm + PP * ldb + 4 * QP;
  for (int i = tid; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  const int64_t xrow = static_cast<int64_t>(nh) * hd;  // step stride, x/y
  const int64_t brow = static_cast<int64_t>(G) * S;    // step stride, B/C
  const float* xh = x + static_cast<int64_t>(h) * hd + p0;
  float* yh = y + static_cast<int64_t>(h) * hd + p0;
  const float* bg = Bm + static_cast<int64_t>(grp) * S;
  const float* cgp = Cm + static_cast<int64_t>(grp) * S;
  const bool vec_bc =
      S % 4 == 0 && (reinterpret_cast<uintptr_t>(Bm) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(Cm) & 15) == 0;
  const bool vec_x = P % 4 == 0 && hd % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int n_chunks = (s + Qk - 1) / Qk;

  auto issue_bca = [&](int ci) {
    const int64_t t0 = static_cast<int64_t>(bb) * s +
                       static_cast<int64_t>(ci) * Qk;
    const int rows = min(Qk, s - ci * Qk);
    copy_rows<kWarps>(Bs, ldb, bg + t0 * brow, brow, rows, Qk, S, vec_bc,
                      warp, lane);
    copy_rows<kWarps>(Cs, ldb, cgp + t0 * brow, brow, rows, Qk, S, vec_bc,
                      warp, lane);
    copy_steps(as, a + t0 * nh + h, nh, rows, Qk, tid);
    cp_async_commit();
  };
  auto issue_xm = [&](int ci) {
    const int64_t t0 = static_cast<int64_t>(bb) * s +
                       static_cast<int64_t>(ci) * Qk;
    const int rows = min(Qk, s - ci * Qk);
    copy_rows<kWarps>(Xs, ldx, xh + t0 * xrow, xrow, rows, Qk, P, vec_x,
                      warp, lane);
    copy_rows<kWarps>(
        Ms, ldm,
        cb + ((static_cast<int64_t>(bb) * n_chunks + ci) * G + grp) * QP *
                 QP,
        QP, QP, QP, QP, true, warp, lane);
    cp_async_commit();
  };

  // work items, dealt to the warps as it = warp + kWarps * q: state
  // blocks of 16 rows x 32 columns, y blocks of 16 x 16
  const int ngu = (SP + 31) / 32;
  const int n_upd = (PP / 16) * ngu;
  const int n_y = (QP / 16) * (PP / 16);
  float st[NI][4][4];  // the state slice, as the update's accumulators
#pragma unroll
  for (int q = 0; q < NI; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[q][u][e] = 0.f;

  issue_bca(0);
  issue_xm(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * Qk;
    const int valid = min(Qk, s - t0);
    cp_async_wait_all();
    __syncthreads();
    // inclusive cumsum of a over the chunk: warp 0, 32 steps at a time
    if (warp == 0) {
      float carry = 0.f;
      for (int base = 0; base < QP; base += 32) {
        const int t = base + lane;
        float v = t < QP ? as[t] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float w = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += w;
        }
        v += carry;
        if (t < QP) acs[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      const float a_end = acs[Qk - 1];
      for (int t = lane; t < QP; t += 32) {
        ea[t] = t < Qk ? expf(acs[t]) : 0.f;
        dte[t] = t < Qk ? expf(a_end - acs[t]) : 0.f;
      }
    }
    __syncthreads();
    const float decay = expf(acs[Qk - 1]);

    // 1. state update in registers: st = decay * st + X^T (dte * B)
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int it = warp + kWarps * q;
      if (it >= n_upd) continue;
      const int mt = it / ngu;
      const int gq = it - mt * ngu;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[q][u][e] *= decay;
      tile_mma<4>(
          st[q], QP,
          [&](int k0, uint32_t* ah, uint32_t* al) {
            load_a_t(Xs, ldx, 16 * mt, k0, gid, tig, ah, al);
          },
          [&](int u, int k0, uint32_t* bh, uint32_t* bl) {
            const int n0 = 32 * gq + 8 * u;
            if (n0 >= SP) return false;
            split_tf32(dte[k0 + tig] * Bs[(k0 + tig) * ldb + n0 + gid],
                       bh[0], bl[0]);
            split_tf32(
                dte[k0 + tig + 4] * Bs[(k0 + tig + 4) * ldb + n0 + gid],
                bh[1], bl[1]);
            return true;
          });
    }

    // 2. y, first term: exp(acs) * (C state^T) with the entering state;
    // y item it covers rows 16 (it / (PP / 16)), columns 16 (it % ...)
    float yreg[NI][2][4];
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int it = warp + kWarps * q;
      if (it >= n_y) continue;
      const int mt = it / (PP / 16);
      const int pn = it - mt * (PP / 16);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) yreg[q][u][e] = 0.f;
      tile_mma<2>(
          yreg[q], SP,
          [&](int k0, uint32_t* ah, uint32_t* al) {
            load_a(Cs, ldb, 16 * mt, k0, gid, tig, ah, al);
          },
          [&](int u, int k0, uint32_t* bh, uint32_t* bl) {
            load_b_nk(St, ldb, 16 * pn + 8 * u, k0, gid, tig, bh, bl);
            return true;
          });
      const float e0 = ea[16 * mt + gid];
      const float e1 = ea[16 * mt + gid + 8];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        yreg[q][u][0] *= e0;
        yreg[q][u][1] *= e0;
        yreg[q][u][2] *= e1;
        yreg[q][u][3] *= e1;
      }
    }
    __syncthreads();  // B, C and a are free
    if (ci + 1 < n_chunks) issue_bca(ci + 1);

    // 3. y += M X with M[i, j] = exp(acs_i - acs_j) C.B^T[i, j] (j <= i)
    // formed as its fragments are loaded, then store
    auto m_at = [&](int i, int j) {
      return j <= i ? expf(acs[i] - acs[j]) * Ms[i * ldm + j] : 0.f;
    };
#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int it = warp + kWarps * q;
      if (it >= n_y) continue;
      const int mt = it / (PP / 16);
      const int pn = it - mt * (PP / 16);
      const int i0 = 16 * mt + gid;
      tile_mma<2>(
          yreg[q], 16 * mt + 16,
          [&](int k0, uint32_t* ah, uint32_t* al) {
            const int j0 = k0 + tig;
            split_tf32(m_at(i0, j0), ah[0], al[0]);
            split_tf32(m_at(i0 + 8, j0), ah[1], al[1]);
            split_tf32(m_at(i0, j0 + 4), ah[2], al[2]);
            split_tf32(m_at(i0 + 8, j0 + 4), ah[3], al[3]);
          },
          [&](int u, int k0, uint32_t* bh, uint32_t* bl) {
            load_b_kn(Xs, ldx, 16 * pn + 8 * u, k0, gid, tig, bh, bl);
            return true;
          });
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mt + gid + 8 * (e >> 1);
          const int p = 16 * pn + 8 * u + 2 * tig + (e & 1);
          if (i < valid && p < P)
            yh[(static_cast<int64_t>(bb) * s + t0 + i) * xrow + p] =
                yreg[q][u][e];
        }
    }
    __syncthreads();  // every y has read the old state, X and C.B^T

#pragma unroll
    for (int q = 0; q < NI; ++q) {
      const int it = warp + kWarps * q;
      if (it >= n_upd) continue;
      const int mt = it / ngu;
      const int gq = it - mt * ngu;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n0 = 32 * gq + 8 * u;
        if (n0 >= SP) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 16 * mt + gid + 8 * (e >> 1);
          const int n = n0 + 2 * tig + (e & 1);
          St[p * ldb + n] = st[q][u][e];
        }
      }
    }
    if (ci + 1 < n_chunks) issue_xm(ci + 1);
  }

  float* so = state_out + (static_cast<int64_t>(bb) * nh + h) * hd * S;
#pragma unroll
  for (int q = 0; q < NI; ++q) {
    const int it = warp + kWarps * q;
    if (it >= n_upd) continue;
    const int mt = it / ngu;
    const int gq = it - mt * ngu;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * mt + gid + 8 * (e >> 1);
        const int n = 32 * gq + 8 * u + 2 * tig + (e & 1);
        if (p < P && n < S)
          so[static_cast<int64_t>(p0 + p) * S + n] = st[q][u][e];
      }
    }
  }
}

size_t scan_smem_floats(int Qk, int P, int S) {
  const size_t QP = (Qk + 15) / 16 * 16;
  const size_t SP = (S + 7) / 8 * 8;
  const size_t PP = (P + 15) / 16 * 16;
  return 2 * QP * (SP + 4) + QP * (PP + 8) + QP * (QP + 4) +
         PP * (SP + 4) + 4 * QP;
}

template <int NI>
cudaError_t launch_scan(const float* x, const float* a, const float* B,
                        const float* C, const float* cb, float* y,
                        float* state, int b, int s, int nh, int hd, int G,
                        int S, int Qk, int ks, size_t smem,
                        cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<NI>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(nh * ks, b), kThreads, smem, stream>>>(
      x, a, B, C, cb, y, state, s, nh, hd, G, S, Qk, ks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Q: the op's chunk length (s is a multiple of it), run in pieces of at
// most 64 steps; scratch: b * pieces * G * QP * QP floats for C.B^T,
// with QP the piece rounded up to 16
int ssd_scan_f32(const void* x, const void* a_log, const void* Bm,
                 const void* Cm, void* y, void* state, void* scratch, int b,
                 int s, int nh, int hd, int G, int S, int Q, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || s <= 0 || nh <= 0) return 0;
  if (Q <= 0 || Q > kMaxDim || hd <= 0 || hd > kMaxDim || S <= 0 ||
      S > kMaxDim || G <= 0 || nh % G != 0 || b > 65535 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Qk = Q <= kMaxChunk ? Q : (Q + 1) / 2;
  const int n_chunks = (s + Qk - 1) / Qk;
  const int ks = hd % 16 == 0 ? 2 : 1;
  const int P = hd / ks;
  // items per warp: the most of either phase (state blocks, y blocks)
  const int qt = (Qk + 15) / 16;
  const int pt = (P + 15) / 16;
  int items = pt * (((S + 7) / 8 * 8 + 31) / 32);
  items = items > qt * pt ? items : qt * pt;
  const int ni = (items + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * scan_smem_floats(Qk, P, S);
  const size_t cb_smem =
      sizeof(float) * 2 * (qt * 16) * ((S + 7) / 8 * 8 + 4);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin) || ni > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a_log);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* cb = static_cast<float*>(scratch);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (cb_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ssd_cb_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(cb_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_cb_kernel<<<dim3(n_chunks, G, b), kCbThreads, cb_smem, st>>>(
      bf, cf, cb, s, G, S, Qk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ni <= 1)
    err = launch_scan<1>(xf, af, bf, cf, cb, yf, sf, b, s, nh, hd, G, S, Qk,
                         ks, smem, st);
  else if (ni <= 2)
    err = launch_scan<2>(xf, af, bf, cf, cb, yf, sf, b, s, nh, hd, G, S, Qk,
                         ks, smem, st);
  else
    err = launch_scan<4>(xf, af, bf, cf, cb, yf, sf, b, s, nh, hd, G, S, Qk,
                         ks, smem, st);
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
