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
// The backward (ssd_scan_bwd_f32): the gradient of y and of the final
// state with respect to x, a, B and C.  No TPU kernel stands behind it:
// the JAX package has no custom_vjp and differentiates its oracle
// ssd_chunked with XLA's autodiff.  It runs in pieces of P <= 64 steps (a
// longer chunk as two pieces, as above).  Per (batch, head), with acs the
// cumulative sum of a over a piece, e = exp(acs), dte = exp(acs_last -
// acs) and eT = exp(acs_last), three kernels, every product on the tensor
// cores in 3xTF32 as in the forward:
// - ssd_cb_kernel (the forward's): C.B^T of every piece and group, once
//   per group and not per head, into fp32 scratch (512 KB at the shape
//   below).
// - ssd_bwd_sweep_kernel: a block per (head, direction, tile of at most
//   64 x 64 of the [hd, S] state: 320 blocks, three per SM, at the shape
//   below), the two directions at once.  Forward from zero it writes the
//   state entering each piece (h' = eT h + X^T (dte B)); back from dstate
//   the adjoint of the state leaving it (dH_prev = eT dH + dY^T (e C)).
//   The tile stays in registers as the update's accumulators, a 16 x 32
//   item per warp; the next piece's operands are copied with cp.async
//   into a second stage while this one computes; the cumulative sum of a
//   is a warp-shuffle scan.  h_{t-1} is never rebuilt by dividing by
//   exp(a_t), which underflows for large dt: the states are kept, and
//   every exp is of a value <= 0.
// - ssd_bwd_piece_kernel: a block per (head, piece, batch).  With
//   L[i, j] = exp(acs_i - acs_j) for j <= i, M = L * (C B^T),
//   D = dY X^T, W = L * D and E = M * D:
//     dX = M^T dY + dte (B dH^T)      dC = W B + e (dY h0)
//     dB = W^T C + dte (X dH)
//     d acs = rowsum E - colsum E + e (C . dY h0) - dte (B . X dH), with
//     eT <dH, h0> + sum_t dte_t (B_t . (X dH)_t) at the last step;
//   da is d acs summed from the end of the piece (warp shuffles).  E is
//   never stored: its row and column sums, M and W are formed from D's
//   fragments.  X, dY, B, M and W sit in shared memory (rows padded for
//   conflict-free fragment loads), 108,564 bytes at the shape below, two
//   blocks per SM; h0, dH and C go from global memory straight into the
//   fragments of the warp that owns their columns, 16 bytes a load (the
//   columns interleaved over a warp's four mma tiles).  dB and dC go out
//   per head; the caller sums them over a group's heads.
// Bound on an H100: operations.  Per piece and head dY X^T, M^T dY, W B
// and W^T C over the lower triangle, the five [P, hd] x [hd, S] products
// (the two sweeps, dY h0, X dH, B dH^T), and C B^T once per group: at
// mamba2-2.7b's training shape (b 1, s 2048, nh 80, hd 64, G 1, S 128,
// P 64) 17.53 GFLOP against 134 MB moved once.  In 3xTF32 that is 3 x
// 17.53 GFLOP at 495 TFLOP/s, about 106 us (262 us as fp32 FMA at 67
// TFLOP/s), above the 40 us the bytes take.
// What still holds it (PERF.md): about 1.03 ms a call at that shape on an
// H100 (sweeps 0.27, pieces 0.69, the caller's sums 0.07;
// tools/kernel_ab.py).  The pieces' states make a round trip through HBM
// (h0 and dH, 84 MB each, written and read), the per-head dB and dC
// partials (168 MB) another before the caller's sums; the sweeps run 32
// dependent pieces per block, and writing the states takes most of their
// time; a piece block waits on its first copies and on its global loads
// with only one other block on the SM to hide them.

// C interface (ctypes): ssd_scan_f32 and ssd_scan_bwd_f32 return a
// cudaError_t as int, 0 on success; the launches go to the caller's
// stream, unsynchronised.

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

// -- the backward: the gradient of y and of the final state ------------------

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

// The sum over the 32 lanes of a warp, the same tree on every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// acc += A B for one 16 x 8 tile in 3xTF32, the three products into the
// one accumulator (a warp here holds many tiles, which hide the latency)
__device__ __forceinline__ void mma3(float acc[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma_tf32(acc, al, bh);
  mma_tf32(acc, ah, bl);
  mma_tf32(acc, ah, bh);
}

// tile_mma with the three products of each tile into its one accumulator:
// fewer registers, for a warp whose NT tiles give the latency enough
// independent chains
template <int NT, class LoadA, class LoadB>
__device__ __forceinline__ void tile_mma_acc(float acc[NT][4], int K,
                                             LoadA load_a, LoadB load_b) {
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a(k0, ah, al);
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      uint32_t bh[2], bl[2];
      if (load_b(u, k0, bh, bl)) mma3(acc[u], ah, al, bh, bl);
    }
  }
}

// Warp 0's part of a piece of P steps: acs the inclusive cumulative sum of
// as[0, QP) (zero past P) by warp shuffles, e = exp(acs) and dte =
// exp(acs_{P-1} - acs) (both zero past P), *eT = exp(acs_{P-1}).  exp is
// only taken of values <= 0.
__device__ __forceinline__ void piece_decays(const float* as, float* acs,
                                             float* e, float* dte, float* eT,
                                             int P, int QP, int lane) {
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
  const float last = acs[P - 1];
  for (int t = lane; t < QP; t += 32) {
    e[t] = t < P ? expf(acs[t]) : 0.f;
    dte[t] = t < P ? expf(last - acs[t]) : 0.f;
  }
  if (lane == 0) *eT = expf(last);
}

// v0, v1 to p[0], p[1] (columns n, n + 1 of a row of n_max): one 8-byte
// store where both exist and the row is even, else what exists; streaming
// (evict-first), as every output of the backward is read once, later
__device__ __forceinline__ void store_pair(float* p, float v0, float v1,
                                           int n, int n_max) {
  if (n + 1 < n_max && (n_max & 1) == 0) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v0, v1));
  } else {
    if (n < n_max) p[0] = v0;
    if (n + 1 < n_max) p[1] = v1;
  }
}

// The sweeps over the pieces of one (batch, head), one direction and one
// tile of at most 64 x 64 of the [hd, S] state per block (blockIdx.x =
// ((head * ks + row slice) * cs + column slice) * 2 + direction):
//   forward, from zero:      h' = eT h + X^T (dte B), saving h0 per piece;
//   back, from dstate:  dH_prev = eT dH + dY^T (e C), saving dH per piece.
// The tile lives in registers as the accumulators of the update, one
// 16 x 32 item per warp, as the forward kernel keeps its state; the next
// piece's B (or C) columns, X (or dY) rows and a are copied with cp.async
// into the other of two stages while this one computes.
__global__ void __launch_bounds__(kBwdThreads, 3)
    ssd_bwd_sweep_kernel(const float* __restrict__ x,
                         const float* __restrict__ a,
                         const float* __restrict__ Bm,
                         const float* __restrict__ Cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ dstate,
                         float* __restrict__ h0, float* __restrict__ dh,
                         int s, int nh, int hd, int G, int S, int P, int ks,
                         int cs) {
  extern __shared__ __align__(16) float smem[];
  const int dir = blockIdx.x & 1;
  int rest = blockIdx.x >> 1;
  const int crank = rest % cs;
  rest /= cs;
  const int rrank = rest % ks;
  const int h = rest / ks;
  const int64_t bi = blockIdx.y;
  const int g = h / (nh / G);
  const int R = (hd + ks - 1) / ks;
  const int CW = up((S + cs - 1) / cs, 8);
  const int p0 = rrank * R;
  const int c0 = crank * CW;
  const int rows = min(R, hd - p0);
  const int cols = min(CW, S - c0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int QP = up(P, 16);
  const int RP = up(R, 16);
  const int ldv = CW + 8;  // B or C rows (the tile's columns)
  const int ldy = RP + 8;  // X or dY rows (the tile's rows)
  const int stage = QP * ldv + QP * ldy + QP;
  float* acs = smem + 2 * stage;  // [QP]
  float* e = acs + QP;            // [QP]
  float* dte = e + QP;            // [QP]
  float* eT = dte + QP;           // [1]
  for (int i = tid; i < 2 * stage + 3 * QP + 1; i += kBwdThreads) smem[i] = 0.f;
  __syncthreads();

  const int nc = s / P;
  const float* in = dir ? dy : x;
  const float* vin = dir ? Cm : Bm;
  const int64_t xrow = static_cast<int64_t>(nh) * hd;
  const int64_t brow = static_cast<int64_t>(G) * S;
  const int64_t plane = static_cast<int64_t>(hd) * S;
  const bool vec_v = S % 4 == 0 && CW % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(vin) & 15) == 0;
  const bool vec_y = hd % 4 == 0 && R % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(in) & 15) == 0;
  float* save = (dir ? dh : h0) + (bi * nc * nh + h) * plane +
                static_cast<int64_t>(p0) * S + c0;

  auto issue = [&](int i) {
    const int c = dir ? nc - 1 - i : i;
    float* Vs = smem + (i & 1) * stage;
    float* Ys = Vs + QP * ldv;
    float* as = Ys + QP * ldy;
    const int64_t t0 = bi * s + static_cast<int64_t>(c) * P;
    copy_rows<kBwdWarps>(Vs, ldv, vin + t0 * brow + g * S + c0, brow, P, P,
                         cols, vec_v, warp, lane);
    copy_rows<kBwdWarps>(Ys, ldy, in + (t0 * nh + h) * hd + p0, xrow, P, P,
                         rows, vec_y, warp, lane);
    copy_steps(as, a + t0 * nh + h, nh, P, QP, tid);
    cp_async_commit();
  };

  // this warp's item: tile rows 16 mt.., columns 32 gq.. (one item per
  // warp: at most 4 x 2 of them)
  const int ngu = (CW + 31) / 32;
  const bool mine = warp < (RP / 16) * ngu;
  const int mt = warp / ngu;
  const int gq = warp - mt * ngu;
  float st[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = 16 * mt + gid + 8 * hf;
      const int n = 32 * gq + 8 * u + 2 * tig;
      float v0 = 0.f, v1 = 0.f;
      if (dir == 1 && mine && p < rows) {
        const float* src = dstate + (bi * nh + h) * plane +
                           static_cast<int64_t>(p0 + p) * S + c0 + n;
        if (n < cols) v0 = src[0];
        if (n + 1 < cols) v1 = src[1];
      }
      st[u][2 * hf] = v0;
      st[u][2 * hf + 1] = v1;
    }

  issue(0);
  if (nc > 1) issue(1);
  for (int i = 0; i < nc; ++i) {
    // the state entering piece c (forward) or leaving it (back)
    const int c = dir ? nc - 1 - i : i;
    float* out = save + static_cast<int64_t>(c) * nh * plane;
    if (mine) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = 16 * mt + gid + 8 * hf;
          const int n = 32 * gq + 8 * u + 2 * tig;
          if (p < rows && n < cols)
            store_pair(out + static_cast<int64_t>(p) * S + n,
                       st[u][2 * hf], st[u][2 * hf + 1], c0 + n, S);
        }
    }
    if (i + 1 < nc)
      cp_async_wait_one();
    else
      cp_async_wait_all();
    __syncthreads();
    const float* Vs = smem + (i & 1) * stage;
    const float* Ys = Vs + QP * ldv;
    if (warp == 0) piece_decays(Ys + QP * ldy, acs, e, dte, eT, P, QP, lane);
    __syncthreads();
    if (mine) {
      const float decay = *eT;
      const float* w = dir ? e : dte;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) st[u][v] *= decay;
      tile_mma_acc<4>(
          st, QP,
          [&](int k0, uint32_t* ah, uint32_t* al) {
            load_a_t(Ys, ldy, 16 * mt, k0, gid, tig, ah, al);
          },
          [&](int u, int k0, uint32_t* bh, uint32_t* bl) {
            const int n0 = 32 * gq + 8 * u;
            if (n0 >= CW) return false;
            split_tf32(w[k0 + tig] * Vs[(k0 + tig) * ldv + n0 + gid], bh[0],
                       bl[0]);
            split_tf32(w[k0 + tig + 4] * Vs[(k0 + tig + 4) * ldv + n0 + gid],
                       bh[1], bl[1]);
            return true;
          });
    }
    __syncthreads();  // this stage and the decays are free
    if (i + 2 < nc) issue(i + 2);
  }
}

// (row slices, column slices) of the sweeps' state tiles: at most 64 x 64
inline int sweep_ks(int hd) { return hd > 64 ? 2 : 1; }
inline int sweep_cs(int S) { return S > 64 ? 2 : 1; }

inline size_t bwd_sweep_floats(int P, int hd, int S) {
  const size_t QP = (P + 15) / 16 * 16;
  const int ks = sweep_ks(hd), cs = sweep_cs(S);
  const size_t ldv = ((S + cs - 1) / cs + 7) / 8 * 8 + 8;
  const size_t ldy = ((hd + ks - 1) / ks + 15) / 16 * 16 + 8;
  return 2 * (QP * ldv + QP * ldy + QP) + 3 * QP + 1;
}

// Shared memory of one piece block, in floats: X and dY [QP, hd32 + 4], B
// [QP, S32 + 4] (hd32, S32: rounded up to 32), M and W [QP, QP + 4]; a,
// acs, e and dte [QP]; the row and column sums of E per 16-wide tile, the
// C.V and B.U sums per 32-column strip of S [4, QP] each; each strip's
// <dH, h0> and exp(acs_last).
inline size_t bwd_piece_floats(int P, int hd, int S) {
  const size_t QP = (P + 15) / 16 * 16;
  const size_t ldx = (hd + 31) / 32 * 32 + 4;
  const size_t ldb = (S + 31) / 32 * 32 + 4;
  return QP * (2 * ldx + ldb + 2 * (QP + 4) + 20) + 5;
}

// p[c .. c + 3] of a row of n floats, zero past n: one 16-byte load where
// the row allows it (vec: n and the row's start a multiple of 4 floats)
__device__ __forceinline__ float4 ld4(const float* p, int c, int n, bool vec) {
  if (vec && c + 3 < n) return *reinterpret_cast<const float4*>(p + c);
  return make_float4(c < n ? p[c] : 0.f, c + 1 < n ? p[c + 1] : 0.f,
                     c + 2 < n ? p[c + 2] : 0.f, c + 3 < n ? p[c + 3] : 0.f);
}

// v to p[c .. c + 3] of a row of n floats, as far as the row goes;
// streaming, as store_pair
__device__ __forceinline__ void st4(float* p, int c, int n, bool vec,
                                    float4 v) {
  if (vec && c + 3 < n) {
    __stcs(reinterpret_cast<float4*>(p + c), v);
  } else {
    if (c < n) p[c] = v.x;
    if (c + 1 < n) p[c + 1] = v.y;
    if (c + 2 < n) p[c + 2] = v.z;
    if (c + 3 < n) p[c + 3] = v.w;
  }
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Everything of one piece of one (batch, head) (blockIdx.x the head, so
// that the blocks in flight read neighbouring planes of h0 and dH), with
// L[i, j] = exp(acs_i - acs_j) for j <= i, M = L * (C B^T) (C.B^T from the
// group's scratch tile), D = dY X^T, W = L * D and E = M * D:
//   dX = M^T dY + dte (B dH^T)     dC = W B + e (dY h0)
//   dB = W^T C + dte (X dH)
//   d acs = rowsum E - colsum E + e (C . dY h0) - dte (B . X dH), with
//   eT <dH, h0> + sum_t dte_t (B_t . (X dH)_t) at the last step;
// da is d acs summed from the end of the piece.  X, dY, B, M and W sit in
// shared memory (the operands that every warp reads); h0, dH and C go from
// global memory straight into the fragments of the warp that owns their
// columns, 16 bytes a load: a warp's 32 columns are interleaved over its
// four 8-column mma tiles (column 4 j + u of the strip is column j of tile
// u), so that the four tiles' values of one row sit side by side, and for
// B dH^T each 16-deep block of K is permuted alike (lane tig's four
// k-values are n = 4 tig .. 4 tig + 3).  dB and dC go out per head.
__global__ void __launch_bounds__(kBwdThreads, 2)
    ssd_bwd_piece_kernel(const float* __restrict__ x,
                         const float* __restrict__ a,
                         const float* __restrict__ Bm,
                         const float* __restrict__ Cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ cb,
                         const float* __restrict__ h0,
                         const float* __restrict__ dh,
                         float* __restrict__ dx, float* __restrict__ da,
                         float* __restrict__ dBh, float* __restrict__ dCh,
                         int s, int nh, int hd, int G, int S, int P) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int g = h / (nh / G);
  const int nc = s / P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int QP = up(P, 16);
  const int T = QP / 16;  // row tiles of a piece, at most 4
  const int HK = up(hd, 8);
  const int ldx = up(hd, 32) + 4;
  const int ldb = up(S, 32) + 4;
  const int ldm = QP + 4;
  const int NS = (S + 31) / 32;   // 32-column strips of S, at most 4
  const int NP = (hd + 31) / 32;  // of hd
  float* Xs = smem;             // [QP, ldx]
  float* dYs = Xs + QP * ldx;   // [QP, ldx]
  float* Bs = dYs + QP * ldx;   // [QP, ldb]
  float* Ms = Bs + QP * ldb;    // [QP, ldm] C.B^T, then M
  float* Ws = Ms + QP * ldm;    // [QP, ldm]
  float* as = Ws + QP * ldm;    // [QP]
  float* acs = as + QP;         // [QP]
  float* e = acs + QP;          // [QP]
  float* dte = e + QP;          // [QP]
  float* rowp = dte + QP;       // [4, QP] rows of E, per 16-column tile
  float* colp = rowp + 4 * QP;  // [4, QP] columns of E, per 16-row tile
  float* fp = colp + 4 * QP;    // [4, QP] C . V, per strip of S
  float* gp = fp + 4 * QP;      // [4, QP] B . U, per strip of S
  float* hp = gp + 4 * QP;      // [4] <dH, h0>, per strip of S
  float* eT = hp + 4;           // [1]
  // the pad rows and columns of X, dY and B, which the copies leave, are
  // zero
  for (int i = tid; i < (QP - P) * (2 * ldx + ldb); i += kBwdThreads) {
    const int r = i / (2 * ldx + ldb), k = i - r * (2 * ldx + ldb);
    (k < 2 * ldx ? Xs + (k / ldx) * QP * ldx + (P + r) * ldx + k % ldx
                 : Bs + (P + r) * ldb + k - 2 * ldx)[0] = 0.f;
  }
  for (int i = tid; i < P * (2 * (ldx - hd) + ldb - S); i += kBwdThreads) {
    const int r = i / (2 * (ldx - hd) + ldb - S);
    const int k = i - r * (2 * (ldx - hd) + ldb - S);
    if (k < 2 * (ldx - hd))
      (k < ldx - hd ? Xs : dYs)[r * ldx + hd + k % (ldx - hd)] = 0.f;
    else
      Bs[r * ldb + S + k - 2 * (ldx - hd)] = 0.f;
  }
  __syncthreads();

  const int64_t t0 = bi * s + static_cast<int64_t>(c) * P;
  const int64_t xrow = static_cast<int64_t>(nh) * hd;
  const int64_t brow = static_cast<int64_t>(G) * S;
  const int64_t plane = static_cast<int64_t>(hd) * S;
  const bool vec_x = hd % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(dy) & 15) == 0;
  const bool vec_b = S % 4 == 0 && (reinterpret_cast<uintptr_t>(Bm) & 15) == 0;
  copy_rows<kBwdWarps>(Xs, ldx, x + (t0 * nh + h) * hd, xrow, P, P, hd, vec_x,
                       warp, lane);
  copy_rows<kBwdWarps>(dYs, ldx, dy + (t0 * nh + h) * hd, xrow, P, P, hd,
                       vec_x, warp, lane);
  copy_rows<kBwdWarps>(Ms, ldm, cb + ((bi * nc + c) * G + g) * QP * QP, QP,
                       QP, QP, QP, true, warp, lane);
  copy_steps(as, a + t0 * nh + h, nh, P, QP, tid);
  cp_async_commit();
  // B, which phase 1 does not read, in a group of its own
  copy_rows<kBwdWarps>(Bs, ldb, Bm + t0 * brow + g * S, brow, P, P, S, vec_b,
                       warp, lane);
  cp_async_commit();
  const float* h0p = h0 + ((bi * nc + c) * nh + h) * plane;
  const float* dhp = dh + ((bi * nc + c) * nh + h) * plane;
  const float* Cg = Cm + t0 * brow + g * S;
  // 16-byte global access: rows of S (h0, dH, C, dB, dC) and of hd (dX)
  const bool vec_s = S % 4 == 0 && (reinterpret_cast<uintptr_t>(h0) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(dh) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(Cm) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(dBh) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(dCh) & 15) == 0;
  const bool vec_d = hd % 4 == 0 && (reinterpret_cast<uintptr_t>(dx) & 15) == 0;
  cp_async_wait_one();
  __syncthreads();
  if (warp == 0) piece_decays(as, acs, e, dte, eT, P, QP, lane);
  __syncthreads();

  // 1. D = dY X^T over the lower 16 x 16 tiles; M = L * (C B^T) and
  // W = L * D in place in shared memory; the row and column sums of
  // E = M * D per tile
  for (int it = warp; it < T * (T + 1) / 2; it += kBwdWarps) {
    int mt = 0;
    while ((mt + 1) * (mt + 2) / 2 <= it) ++mt;
    const int nt = it - mt * (mt + 1) / 2;
    float d[2][4] = {};
    tile_mma<2>(
        d, HK,
        [&](int k0, uint32_t* ah, uint32_t* al) {
          load_a(dYs, ldx, 16 * mt, k0, gid, tig, ah, al);
        },
        [&](int u, int k0, uint32_t* bh, uint32_t* bl) {
          load_b_nk(Xs, ldx, 16 * nt + 8 * u, k0, gid, tig, bh, bl);
          return true;
        });
    float rs[2] = {0.f, 0.f};
    float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int i = 16 * mt + gid + 8 * (v >> 1);
        const int j = 16 * nt + 8 * u + 2 * tig + (v & 1);
        const float L = j <= i ? expf(acs[i] - acs[j]) : 0.f;
        const float m = L * Ms[i * ldm + j];
        const float en = m * d[u][v];
        Ms[i * ldm + j] = m;
        Ws[i * ldm + j] = L * d[u][v];
        rs[v >> 1] += en;
        cs[u][v & 1] += en;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          cs[u][v] += __shfl_xor_sync(0xffffffffu, cs[u][v], o);
    if (tig == 0) {
      rowp[nt * QP + 16 * mt + gid] = rs[0];
      rowp[nt * QP + 16 * mt + gid + 8] = rs[1];
    }
    if (gid == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          colp[mt * QP + 16 * nt + 8 * u + 2 * tig + v] = cs[u][v];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. dX = dte (B dH^T) + M^T dY: a warp per 16 rows and 32 columns of
  // hd; dH from global memory, four k-values of a row per load
  for (int it = warp; it < T * NP; it += kBwdWarps) {
    const int jt = it / NP;
    const int pc = 32 * (it - jt * NP);
    float acc[4][4] = {};
#pragma unroll 2
    for (int kb = 0; kb < S; kb += 16) {
      float4 hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = pc + 4 * gid + u;
        hv[u] = p < hd ? ld4(dhp + p * S, kb + 4 * tig, S, vec_s)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4 r0 = *reinterpret_cast<const float4*>(
          Bs + (16 * jt + gid) * ldb + kb + 4 * tig);
      const float4 r1 = *reinterpret_cast<const float4*>(
          Bs + (16 * jt + gid + 8) * ldb + kb + 4 * tig);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t ah[4], al[4];
        split_tf32(half ? r0.z : r0.x, ah[0], al[0]);
        split_tf32(half ? r1.z : r1.x, ah[1], al[1]);
        split_tf32(half ? r0.w : r0.y, ah[2], al[2]);
        split_tf32(half ? r1.w : r1.y, ah[3], al[3]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          uint32_t bh[2], bl[2];
          split_tf32(half ? hv[u].z : hv[u].x, bh[0], bl[0]);
          split_tf32(half ? hv[u].w : hv[u].y, bh[1], bl[1]);
          mma3(acc[u], ah, al, bh, bl);
        }
      }
    }
    const float d0 = dte[16 * jt + gid];
    const float d1 = dte[16 * jt + gid + 8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[u][0] *= d0;
      acc[u][1] *= d0;
      acc[u][2] *= d1;
      acc[u][3] *= d1;
    }
    for (int k0 = 16 * jt; k0 < QP; k0 += 8) {  // M[i][j] = 0 for i < j
      uint32_t ah[4], al[4];
      load_a_t(Ms, ldm, 16 * jt, k0, gid, tig, ah, al);
      const float4 b0 = *reinterpret_cast<const float4*>(
          dYs + (k0 + tig) * ldx + pc + 4 * gid);
      const float4 b1 = *reinterpret_cast<const float4*>(
          dYs + (k0 + tig + 4) * ldx + pc + 4 * gid);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t bh[2], bl[2];
        split_tf32(comp(b0, u), bh[0], bl[0]);
        split_tf32(comp(b1, u), bh[1], bl[1]);
        mma3(acc[u], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = 16 * jt + gid + 8 * hf;
        if (j < P)
          st4(dx + ((t0 + j) * nh + h) * hd, pc + 8 * tig + 4 * q, hd, vec_d,
              make_float4(acc[0][2 * hf + q], acc[1][2 * hf + q],
                          acc[2][2 * hf + q], acc[3][2 * hf + q]));
      }
  }

  // 3. dC = e (dY h0) + W B, and the C . (dY h0) sums: a warp per 32
  // rows and 32 columns of S; h0 and C from global memory
  for (int it = warp; it < 2 * NS; it += kBwdWarps) {
    const int ns = it >> 1;
    const int m0 = 2 * (it & 1);  // first of the warp's two row tiles
    const int nc0 = 32 * ns;
    if (m0 >= T) continue;
    float acc[2][4][4] = {};
    for (int kb = 0; kb < HK; kb += 32) {
      float4 hv[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = kb + 8 * kk + tig + 4 * hf;
          hv[kk][hf] = p < hd ? ld4(h0p + p * S, nc0 + 4 * gid, S, vec_s)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k0 = kb + 8 * kk;
        if (k0 >= HK) break;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          split_tf32(comp(hv[kk][0], u), bh[u][0], bl[u][0]);
          split_tf32(comp(hv[kk][1], u), bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          if (m0 + mm >= T) break;
          uint32_t ah[4], al[4];
          load_a(dYs, ldx, 16 * (m0 + mm), k0, gid, tig, ah, al);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma3(acc[mm][u], ah, al, bh[u], bl[u]);
        }
      }
    }
    // the C . V sums of each row over the strip, then V scaled by e
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * (m0 + mm) + gid + 8 * hf;
        float f = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 cv = i < P ? ld4(Cg + i * brow, nc0 + 8 * tig + 4 * q,
                                        S, vec_s)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            f += comp(cv, u) * acc[mm][u][2 * hf + q];
            acc[mm][u][2 * hf + q] *= e[i];
          }
        }
        f += __shfl_xor_sync(0xffffffffu, f, 1);
        f += __shfl_xor_sync(0xffffffffu, f, 2);
        if (tig == 0 && m0 + mm < T) fp[ns * QP + i] = f;
      }
    for (int k0 = 0; k0 < 16 * min(m0 + 2, T); k0 += 8) {  // W[i][j] = 0, j > i
      const float4 b0 = *reinterpret_cast<const float4*>(
          Bs + (k0 + tig) * ldb + nc0 + 4 * gid);
      const float4 b1 = *reinterpret_cast<const float4*>(
          Bs + (k0 + tig + 4) * ldb + nc0 + 4 * gid);
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        split_tf32(comp(b0, u), bh[u][0], bl[u][0]);
        split_tf32(comp(b1, u), bh[u][1], bl[u][1]);
      }
#pragma unroll
      for (int mm = 0; mm < 2; ++mm) {
        const int m = m0 + mm;
        if (m >= T || k0 >= 16 * m + 16) continue;
        uint32_t ah[4], al[4];
        load_a(Ws, ldm, 16 * m, k0, gid, tig, ah, al);
#pragma unroll
        for (int u = 0; u < 4; ++u) mma3(acc[mm][u], ah, al, bh[u], bl[u]);
      }
    }
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 16 * (m0 + mm) + gid + 8 * hf;
          if (m0 + mm < T && i < P)
            st4(dCh + ((t0 + i) * nh + h) * S, nc0 + 8 * tig + 4 * q, S, vec_s,
                make_float4(acc[mm][0][2 * hf + q], acc[mm][1][2 * hf + q],
                            acc[mm][2][2 * hf + q], acc[mm][3][2 * hf + q]));
        }
  }

  // 4. dB = dte (X dH) + W^T C, the B . (X dH) sums and <dH, h0>: the same
  // warps' tiles; dH, h0 and C from global memory
  for (int it = warp; it < 2 * NS; it += kBwdWarps) {
    const int ns = it >> 1;
    const int m0 = 2 * (it & 1);
    const int nc0 = 32 * ns;
    if (m0 >= T) continue;
    float acc[2][4][4] = {};
    float hsum = 0.f;
    for (int kb = 0; kb < HK; kb += 32) {
      float4 dv[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = kb + 8 * kk + tig + 4 * hf;
          dv[kk][hf] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (p < hd) {
            dv[kk][hf] = ld4(dhp + p * S, nc0 + 4 * gid, S, vec_s);
            if (m0 == 0) {  // each element of the plane once
              const float4 hw = ld4(h0p + p * S, nc0 + 4 * gid, S, vec_s);
              hsum += dv[kk][hf].x * hw.x + dv[kk][hf].y * hw.y +
                      dv[kk][hf].z * hw.z + dv[kk][hf].w * hw.w;
            }
          }
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k0 = kb + 8 * kk;
        if (k0 >= HK) break;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          split_tf32(comp(dv[kk][0], u), bh[u][0], bl[u][0]);
          split_tf32(comp(dv[kk][1], u), bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          if (m0 + mm >= T) break;
          uint32_t ah[4], al[4];
          load_a(Xs, ldx, 16 * (m0 + mm), k0, gid, tig, ah, al);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma3(acc[mm][u], ah, al, bh[u], bl[u]);
        }
      }
    }
    hsum = warp_sum(hsum);
    if (lane == 0 && m0 == 0) hp[ns] = hsum;
    // the B . U sums of each row over the strip, then U scaled by dte
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * (m0 + mm) + gid + 8 * hf;
        float gsum = 0.f;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = nc0 + 8 * tig + 4 * q;
          const float4 bv = m0 + mm < T
                                ? *reinterpret_cast<const float4*>(
                                      Bs + i * ldb + n)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (n + u < S) gsum += comp(bv, u) * acc[mm][u][2 * hf + q];
            acc[mm][u][2 * hf + q] *= dte[i];
          }
        }
        gsum += __shfl_xor_sync(0xffffffffu, gsum, 1);
        gsum += __shfl_xor_sync(0xffffffffu, gsum, 2);
        if (tig == 0 && m0 + mm < T) gp[ns * QP + i] = gsum;
      }
    for (int kb = 16 * m0; kb < QP; kb += 32) {  // W[i][j] = 0 for i < j
      float4 cv[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = kb + 8 * kk + tig + 4 * hf;
          cv[kk][hf] = i < P ? ld4(Cg + i * brow, nc0 + 4 * gid, S, vec_s)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k0 = kb + 8 * kk;
        if (k0 >= QP) break;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          split_tf32(comp(cv[kk][0], u), bh[u][0], bl[u][0]);
          split_tf32(comp(cv[kk][1], u), bh[u][1], bl[u][1]);
        }
#pragma unroll
        for (int mm = 0; mm < 2; ++mm) {
          const int m = m0 + mm;
          if (m >= T || 16 * m >= k0 + 8) continue;
          uint32_t ah[4], al[4];
          load_a_t(Ws, ldm, 16 * m, k0, gid, tig, ah, al);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma3(acc[mm][u], ah, al, bh[u], bl[u]);
        }
      }
    }
#pragma unroll
    for (int mm = 0; mm < 2; ++mm)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 16 * (m0 + mm) + gid + 8 * hf;
          if (m0 + mm < T && i < P)
            st4(dBh + ((t0 + i) * nh + h) * S, nc0 + 8 * tig + 4 * q, S, vec_s,
                make_float4(acc[mm][0][2 * hf + q], acc[mm][1][2 * hf + q],
                            acc[mm][2][2 * hf + q], acc[mm][3][2 * hf + q]));
        }
  }
  __syncthreads();

  // 5. da: d acs per step from the partial sums (in a fixed order), the
  // last step's own terms, summed from the end of the piece by shuffles
  if (warp == 0) {
    float dv[2], gk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = 32 * r + lane;
      dv[r] = gk[r] = 0.f;
      if (t < P) {
        float row = 0.f, col = 0.f, f = 0.f, gg = 0.f;
        for (int q = 0; q <= t / 16; ++q) row += rowp[q * QP + t];
        for (int q = t / 16; q < T; ++q) col += colp[q * QP + t];
        for (int q = 0; q < NS; ++q) {
          f += fp[q * QP + t];
          gg += gp[q * QP + t];
        }
        gk[r] = dte[t] * gg;
        dv[r] = row - col + e[t] * f - gk[r];
      }
    }
    float hs = 0.f;
    for (int q = 0; q < NS; ++q) hs += hp[q];
    const float last = *eT * hs + warp_sum(gk[0] + gk[1]);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (32 * r + lane == P - 1) dv[r] += last;
    float carry = 0.f;
#pragma unroll
    for (int r = 1; r >= 0; --r) {
      float v = dv[r];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float w = __shfl_down_sync(0xffffffffu, v, off);
        if (lane + off < 32) v += w;
      }
      v += carry;
      carry = __shfl_sync(0xffffffffu, v, 0);
      const int t = 32 * r + lane;
      if (t < P) da[(t0 + t) * nh + h] = v;
    }
  }
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

  // set on every call: the backward sets this kernel's limit to its own
  // pieces' need, which may be below this chunk's (and below 48 KiB)
  err = cudaFuncSetAttribute(ssd_cb_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cb_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
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

// The backward of ssd_scan_f32 (see the header): s is a multiple of the
// piece P <= 64, zero-padded as the forward pads; cb is scratch of
// b * (s / P) * G * QP * QP floats for C.B^T (QP the piece rounded up to
// 16), h0 and dh scratch of b * (s / P) * nh * hd * S floats each (the
// heads of a piece side by side); dB and dC take each head's partial
// [b, s, nh, S], for the caller to sum over a group's heads.
int ssd_scan_bwd_f32(const void* x, const void* a_log, const void* Bm,
                     const void* Cm, const void* dy, const void* dstate,
                     void* cb, void* h0, void* dh, void* dx, void* da,
                     void* dB, void* dC, int b, int s, int nh, int hd, int G,
                     int S, int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || s <= 0 || nh <= 0) return 0;
  if (P <= 0 || P > kMaxChunk || s % P != 0 || hd <= 0 || hd > kMaxDim ||
      S <= 0 || S > kMaxDim || G <= 0 || nh % G != 0 || b > 65535 ||
      nh > 65535 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int QP = (P + 15) / 16 * 16;
  const int SP = (S + 7) / 8 * 8;
  const int ks = sweep_ks(hd);
  const int cs = sweep_cs(S);
  const size_t cb_smem = sizeof(float) * 2 * QP * (SP + 4);
  const size_t sweep_smem = sizeof(float) * bwd_sweep_floats(P, hd, S);
  const size_t piece_smem = sizeof(float) * bwd_piece_floats(P, hd, S);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sweep_smem > static_cast<size_t>(optin) ||
      piece_smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a_log);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* dyf = static_cast<const float*>(dy);
  float* cbf = static_cast<float*>(cb);
  float* h0f = static_cast<float*>(h0);
  float* dhf = static_cast<float*>(dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // C.B^T of every piece and group, as the forward forms it
  err = cudaFuncSetAttribute(ssd_cb_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(cb_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_cb_kernel<<<dim3(s / P, G, b), kCbThreads, cb_smem, st>>>(bf, cf, cbf,
                                                                s, G, S, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sweep_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_sweep_kernel<<<dim3(nh * ks * cs * 2, b), kBwdThreads, sweep_smem,
                         st>>>(xf, af, bf, cf, dyf,
                               static_cast<const float*>(dstate), h0f, dhf, s,
                               nh, hd, G, S, P, ks, cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_piece_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(piece_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_piece_kernel<<<dim3(nh, s / P, b), kBwdThreads, piece_smem, st>>>(
      xf, af, bf, cf, dyf, cbf, h0f, dhf, static_cast<float*>(dx),
      static_cast<float*>(da), static_cast<float*>(dB),
      static_cast<float*>(dC), s, nh, hd, G, S, P);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
