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
// acs) and eT = exp(acs_last):
// - ssd_bwd_sweep_kernel: a sweep forward writes the state entering each
//   piece (h' = eT h + X^T (dte B), from zero) and a sweep back the
//   adjoint of the state leaving it (dH_prev = eT dH + dY^T (e C), from
//   dstate) to fp32 scratch; one block per 16 state rows of a head.
//   h_{t-1} is never rebuilt by dividing by exp(a_t), which underflows
//   for large dt: the states are kept, and every exp is of a value <= 0.
// - ssd_bwd_piece_kernel: one block per (piece, head, batch).  With
//   L[i, j] = exp(acs_i - acs_j) for j <= i, M = L * (C B^T),
//   W = L * (dY X^T) and E = M * (dY X^T):
//     dX = M^T dY + dte (B dH^T)      dC = W B + e (dY h0)
//     dB = W^T C + dte (X dH)
//     d acs = rowsum E - colsum E + e (C . dY h0) - dte (B . X dH), with
//     eT <dH, h0> + sum_t dte_t (B_t . (X dH)_t) at the last step;
//   da is d acs summed from the end of the piece.  dB and dC go out per
//   head; the caller sums them over a group's heads.
// Bound on an H100: operations.  Per piece and head dY X^T, M^T dY, W B
// and W^T C over the lower triangle, the five [P, hd] x [hd, S] products
// (the two sweeps, dY h0, X dH, B dH^T), and C B^T once per group: at
// mamba2-2.7b's training shape (b 1, s 2048, nh 80, hd 64, G 1, S 128,
// P 64) 17.5 GFLOP against 134 MB moved once.  In fp32 FMA outside the
// tensor cores (67 TFLOP/s, the H100 SXM data sheet) the least time is
// about 262 us, above the 40 us the bytes take.
// What the simple design leaves for later: every product is an fp32 FMA
// from shared memory, a warp-wide load per FMA (a quarter of the FMA
// rate at best); C B^T is formed per head, not once per group; the
// pieces' states make a round trip through HBM (2 x 84 MB at the shape
// above); one 184 KB block per SM hides no load behind math.  The next
// step is the forward's: the chunked products on the tensor cores in
// 3xTF32, the states kept on chip.
//
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
constexpr int kSweepRows = 16;  // state rows (of hd) per sweep block
constexpr int kSweepPer = kSweepRows * kMaxDim / kBwdThreads;

// A piece's log decays (one load per thread), their cumulative sum in
// order by one thread, and the decays the piece needs: e = exp(acs),
// dte = exp(acs_last - acs) and exp(acs_last) in *eT.  Every thread of
// the block calls it; it ends synchronised.  exp is only taken of values
// <= 0.
__device__ __forceinline__ void piece_decays(const float* a, int64_t stride,
                                             int P, float* acs, float* e,
                                             float* dte, float* eT) {
  const int tid = threadIdx.x;
  if (tid < P) acs[tid] = a[tid * stride];
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int t = 0; t < P; ++t) {
      run += acs[t];
      acs[t] = run;
    }
    *eT = expf(run);
  }
  __syncthreads();
  if (tid < P) {
    e[tid] = expf(acs[tid]);
    dte[tid] = expf(acs[P - 1] - acs[tid]);
  }
  __syncthreads();
}

// The two sweeps over the pieces of one (batch, head), kSweepRows rows of
// the [hd, S] state per block: forward from the zero state, writing the
// state that enters each piece to h0; then back from dstate, writing the
// adjoint of the state that leaves each piece to dh.  Every element of
// the state is updated on its own, so its rows split over blocks freely.
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_sweep_kernel(const float* __restrict__ x,
                         const float* __restrict__ a,
                         const float* __restrict__ Bm,
                         const float* __restrict__ Cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ dstate,
                         float* __restrict__ h0, float* __restrict__ dh,
                         int s, int nh, int hd, int G, int S, int P) {
  __shared__ float acs[kMaxChunk], e[kMaxChunk], dte[kMaxChunk], eT;
  __shared__ float Xs[kMaxChunk][kSweepRows];
  __shared__ float Bs[kMaxChunk][kMaxDim];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kSweepRows;
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int g = h / (nh / G);
  const int nc = s / P;
  const int ne = kSweepRows * S;
  const int64_t plane = static_cast<int64_t>(hd) * S;
  float st[kSweepPer];
  int64_t off[kSweepPer];  // each element's offset in a [hd, S] plane
  bool mine[kSweepPer];
#pragma unroll
  for (int k = 0; k < kSweepPer; ++k) {
    const int el = tid + k * kBwdThreads;
    mine[k] = el < ne && r0 + el / S < hd;
    off[k] = static_cast<int64_t>(r0 + el / S) * S + el % S;
  }
  for (int dir = 0; dir < 2; ++dir) {
    // dir 0: h' = eT h + sum_t (dte_t x_t) B_t from zero;
    // dir 1: dH_prev = eT dH + sum_t (e_t dy_t) C_t from dstate
    const float* in = dir == 0 ? x : dy;
    const float* vec = dir == 0 ? Bm : Cm;
    float* save = (dir == 0 ? h0 : dh) + (bi * nh + h) * nc * plane;
#pragma unroll
    for (int k = 0; k < kSweepPer; ++k)
      st[k] = (dir == 1 && mine[k]) ? dstate[(bi * nh + h) * plane + off[k]]
                                    : 0.f;
    for (int i = 0; i < nc; ++i) {
      const int c = dir == 0 ? i : nc - 1 - i;
      const int64_t t0 = bi * s + static_cast<int64_t>(c) * P;
#pragma unroll
      for (int k = 0; k < kSweepPer; ++k)
        if (mine[k]) save[c * plane + off[k]] = st[k];
      __syncthreads();  // the last piece's reads of shared memory are done
      piece_decays(a + t0 * nh + h, nh, P, acs, e, dte, &eT);
      // unrolled so that each thread has several loads in flight
#pragma unroll 4
      for (int idx = tid; idx < P * kSweepRows; idx += kBwdThreads) {
        const int t = idx / kSweepRows, r = idx % kSweepRows;
        Xs[t][r] = r0 + r < hd ? in[((t0 + t) * nh + h) * hd + r0 + r] : 0.f;
      }
#pragma unroll 8
      for (int idx = tid; idx < P * S; idx += kBwdThreads) {
        const int t = idx / S, n = idx % S;
        Bs[t][n] = vec[((t0 + t) * G + g) * S + n];
      }
      __syncthreads();
      const float* w = dir == 0 ? dte : e;
#pragma unroll
      for (int k = 0; k < kSweepPer; ++k) {
        if (!mine[k]) continue;
        const int el = tid + k * kBwdThreads;
        const int r = el / S, n = el % S;
        float acc = 0.f;
        for (int t = 0; t < P; ++t) acc = fmaf(w[t] * Xs[t][r], Bs[t][n], acc);
        st[k] = eT * st[k] + acc;
      }
    }
    __syncthreads();
  }
}

// The sum over the 32 lanes of a warp, the same tree on every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of one piece block, in floats: X and dY [P, hd + 1], B
// and C [P, S + 1], the state [hd, S + 1] (h0, then dH), M, W and E
// [P, P + 1], five [P] vectors (acs, e, dte, d acs, the G terms) and the
// warps' partial sums with exp(acs_last).  The + 1 keeps the column reads
// free of bank conflicts.
inline size_t bwd_smem_floats(int P, int hd, int S) {
  return static_cast<size_t>(2 * P * (hd + 1) + 2 * P * (S + 1) +
                             hd * (S + 1) + 3 * P * (P + 1) + 5 * P +
                             kBwdWarps + 1);
}

// Everything of one piece of one (batch, head): dX, da, and the head's
// dB and dC partials (the caller sums them over a group's heads).
__global__ void __launch_bounds__(kBwdThreads)
    ssd_bwd_piece_kernel(const float* __restrict__ x,
                         const float* __restrict__ a,
                         const float* __restrict__ Bm,
                         const float* __restrict__ Cm,
                         const float* __restrict__ dy,
                         const float* __restrict__ h0,
                         const float* __restrict__ dh,
                         float* __restrict__ dx, float* __restrict__ da,
                         float* __restrict__ dBh, float* __restrict__ dCh,
                         int s, int nh, int hd, int G, int S, int P) {
  extern __shared__ float smem[];
  const int XW = hd + 1, SW = S + 1, PW = P + 1;
  float* Xs = smem;
  float* dYs = Xs + P * XW;
  float* Bs = dYs + P * XW;
  float* Cs = Bs + P * SW;
  float* Hs = Cs + P * SW;
  float* Ms = Hs + hd * SW;
  float* Ws = Ms + P * PW;
  float* Es = Ws + P * PW;
  float* acs = Es + P * PW;
  float* e = acs + P;
  float* dte = e + P;
  float* dacs = dte + P;
  float* gk = dacs + P;
  float* part = gk + P;  // kBwdWarps partial sums, then exp(acs_last)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x, h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int g = h / (nh / G);
  const int nc = s / P;
  const int64_t t0 = bi * s + static_cast<int64_t>(c) * P;
  const int64_t plane = static_cast<int64_t>(hd) * S;
  const float* h0_p = h0 + ((bi * nh + h) * nc + c) * plane;
  const float* dh_p = dh + ((bi * nh + h) * nc + c) * plane;

  piece_decays(a + t0 * nh + h, nh, P, acs, e, dte, part + kBwdWarps);
  // the loads are unrolled so that each thread has several in flight
#pragma unroll 8
  for (int idx = tid; idx < P * hd; idx += kBwdThreads) {
    const int t = idx / hd, p = idx % hd;
    const int64_t o = ((t0 + t) * nh + h) * hd + p;
    Xs[t * XW + p] = x[o];
    dYs[t * XW + p] = dy[o];
  }
#pragma unroll 8
  for (int idx = tid; idx < P * S; idx += kBwdThreads) {
    const int t = idx / S, n = idx % S;
    const int64_t o = ((t0 + t) * G + g) * S + n;
    Bs[t * SW + n] = Bm[o];
    Cs[t * SW + n] = Cm[o];
  }
#pragma unroll 8
  for (int idx = tid; idx < hd * S; idx += kBwdThreads)
    Hs[(idx / S) * SW + idx % S] = h0_p[idx];
  __syncthreads();

  // M = L * (C B^T), W = L * (dY X^T), E = M * (dY X^T), zero above the
  // diagonal
  for (int idx = tid; idx < P * P; idx += kBwdThreads) {
    const int i = idx / P, j = idx % P;
    float m = 0.f, w = 0.f, en = 0.f;
    if (j <= i) {
      float cb = 0.f, d = 0.f;
      for (int n = 0; n < S; ++n) cb = fmaf(Cs[i * SW + n], Bs[j * SW + n], cb);
      for (int p = 0; p < hd; ++p) d = fmaf(dYs[i * XW + p], Xs[j * XW + p], d);
      const float L = expf(acs[i] - acs[j]);
      m = L * cb;
      w = L * d;
      en = m * d;
    }
    Ms[i * PW + j] = m;
    Ws[i * PW + j] = w;
    Es[i * PW + j] = en;
  }
  // <dH, h0> over the piece: per thread, per warp, then the warps in order
  float hdot = 0.f;
#pragma unroll 8
  for (int idx = tid; idx < hd * S; idx += kBwdThreads)
    hdot = fmaf(dh_p[idx], Hs[(idx / S) * SW + idx % S], hdot);
  hdot = warp_sum(hdot);
  if (lane == 0) part[warp] = hdot;
  __syncthreads();

  // d acs = row sum of E - column sum of E
  for (int k = tid; k < P; k += kBwdThreads) {
    float row = 0.f, col = 0.f;
    for (int j = 0; j < P; ++j) row += Es[k * PW + j];
    for (int i = 0; i < P; ++i) col += Es[i * PW + k];
    dacs[k] = row - col;
  }
  __syncthreads();

  // dC = W B + e (dY h0), and d acs += e (C . dY h0); a warp per row
  for (int i = warp; i < P; i += kBwdWarps) {
    float v[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < hd; ++p) {
      const float d = dYs[i * XW + p];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (lane + 32 * m < S) v[m] = fmaf(d, Hs[p * SW + lane + 32 * m], v[m]);
    }
    for (int j = 0; j <= i; ++j) {
      const float w = Ws[i * PW + j];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (lane + 32 * m < S)
          t1[m] = fmaf(w, Bs[j * SW + lane + 32 * m], t1[m]);
    }
    float f = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = lane + 32 * m;
      if (n < S) {
        dCh[((t0 + i) * nh + h) * S + n] = t1[m] + e[i] * v[m];
        f = fmaf(Cs[i * SW + n], v[m], f);
      }
    }
    f = warp_sum(f);
    if (lane == 0) dacs[i] += e[i] * f;
  }
  __syncthreads();
#pragma unroll 8
  for (int idx = tid; idx < hd * S; idx += kBwdThreads)
    Hs[(idx / S) * SW + idx % S] = dh_p[idx];
  __syncthreads();

  // dB = W^T C + dte (X dH), and the G terms dte (B . X dH); a warp per row
  for (int j = warp; j < P; j += kBwdWarps) {
    float u[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = 0; p < hd; ++p) {
      const float xv = Xs[j * XW + p];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (lane + 32 * m < S)
          u[m] = fmaf(xv, Hs[p * SW + lane + 32 * m], u[m]);
    }
    for (int i = j; i < P; ++i) {
      const float w = Ws[i * PW + j];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (lane + 32 * m < S)
          t1[m] = fmaf(w, Cs[i * SW + lane + 32 * m], t1[m]);
    }
    float gs = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int n = lane + 32 * m;
      if (n < S) {
        dBh[((t0 + j) * nh + h) * S + n] = t1[m] + dte[j] * u[m];
        gs = fmaf(Bs[j * SW + n], u[m], gs);
      }
    }
    gs = warp_sum(gs);
    if (lane == 0) gk[j] = dte[j] * gs;
  }

  // dX = M^T dY + dte (B dH^T); a warp per row, its lanes over hd
  for (int j = warp; j < P; j += kBwdWarps) {
    float t1[4] = {0.f, 0.f, 0.f, 0.f}, t2[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = j; i < P; ++i) {
      const float mij = Ms[i * PW + j];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (lane + 32 * m < hd)
          t1[m] = fmaf(mij, dYs[i * XW + lane + 32 * m], t1[m]);
    }
    for (int n = 0; n < S; ++n) {
      const float bv = Bs[j * SW + n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (lane + 32 * m < hd)
          t2[m] = fmaf(bv, Hs[(lane + 32 * m) * SW + n], t2[m]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
      if (lane + 32 * m < hd)
        dx[((t0 + j) * nh + h) * hd + lane + 32 * m] = t1[m] + dte[j] * t2[m];
  }
  __syncthreads();

  // da: d acs minus the G terms, with the last step's own terms, summed
  // from the end of the piece
  if (tid == 0) {
    float hsum = 0.f, gsum = 0.f;
    for (int w = 0; w < kBwdWarps; ++w) hsum += part[w];
    for (int t = 0; t < P; ++t) gsum += gk[t];
    float run = 0.f;
    for (int t = P - 1; t >= 0; --t) {
      float d = dacs[t] - gk[t];
      if (t == P - 1) d += part[kBwdWarps] * hsum + gsum;
      run += d;
      da[(t0 + t) * nh + h] = run;
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

// The backward of ssd_scan_f32 (see the header): s is a multiple of the
// piece P <= 64, zero-padded as the forward pads; h0 and dh are scratch
// of b * nh * (s / P) * hd * S floats each; dB and dC take each head's
// partial [b, s, nh, S], for the caller to sum over a group's heads.
int ssd_scan_bwd_f32(const void* x, const void* a_log, const void* Bm,
                     const void* Cm, const void* dy, const void* dstate,
                     void* h0, void* dh, void* dx, void* da, void* dB,
                     void* dC, int b, int s, int nh, int hd, int G, int S,
                     int P, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || s <= 0 || nh <= 0) return 0;
  if (P <= 0 || P > kMaxChunk || s % P != 0 || hd <= 0 || hd > kMaxDim ||
      S <= 0 || S > kMaxDim || G <= 0 || nh % G != 0 || b > 65535 ||
      nh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * bwd_smem_floats(P, hd, S);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a_log);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* dyf = static_cast<const float*>(dy);
  float* h0f = static_cast<float*>(h0);
  float* dhf = static_cast<float*>(dh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  ssd_bwd_sweep_kernel<<<dim3((hd + kSweepRows - 1) / kSweepRows, nh, b),
                         kBwdThreads, 0, st>>>(
      xf, af, bf, cf, dyf, static_cast<const float*>(dstate), h0f, dhf, s,
      nh, hd, G, S, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ssd_bwd_piece_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_bwd_piece_kernel<<<dim3(s / P, nh, b), kBwdThreads, smem, st>>>(
      xf, af, bf, cf, dyf, h0f, dhf, static_cast<float*>(dx),
      static_cast<float*>(da), static_cast<float*>(dB),
      static_cast<float*>(dC), s, nh, hd, G, S, P);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
