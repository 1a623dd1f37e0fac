// Mamba2 chunked SSD scan (state-space duality) from a zero state.
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
// the update follows.
//
// Bound on an H100: operations.  Per (head, chunk) the work is four
// fp32 products of about Q*S*hd multiply-adds each (C.B^T, M.X, the
// inter-chunk term and the state update), against X, y and the state
// moving once: at mamba2-2.7b's shapes (Q 64, hd 64, S 128) about
// 2.6 MFLOP per 33 KB of HBM traffic, far above the fp32 ridge.
//
// Design (simple and right first): one block of 256 threads per (b, h)
// walks its chunks in order and keeps the [hd, S] state in shared memory
// for the whole sequence, so it never goes to HBM between chunks.  Per
// chunk the block stages X [Q, hd] and B [Q, S] in shared memory, scans
// a with warp shuffles, and then, for each tile of up to 64 rows, stages
// the tile's C rows, forms the decay-weighted scores M, and writes the
// tile's y.  Only then does it scale B by the decay to the chunk's end
// and update the state.  Every product is fp32 FMA from shared memory,
// each thread holding a 4 x 4 or 4 x 8 register tile; rows of B, C and
// the state are padded to S + 1 floats so that the 16 threads that read
// 16 different rows hit 16 different banks.  exp is only ever taken of
// acs_i - acs_j for j <= i (<= 0): the upper triangle, which could
// overflow, is never exponentiated, where the TPU kernel masks it after
// the fact and a GPU would turn inf * 0 into NaN.  Q may be any length
// up to 128 (the op pads s to a multiple of Q); head_dim and S at most
// 128.  What it leaves for later: no tensor cores (TF32 would change the
// arithmetic), B.C^T recomputed by every head of a group, at most one
// block per SM at these shapes (about 130 KB of shared memory), and
// b * nh = 80 blocks for 132 SMs at batch 1.
//
// C interface (ctypes): ssd_scan_f32 returns a cudaError_t as int, 0 on
// success; the launch goes to the caller's stream, unsynchronised.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kTile = 64;      // rows of a chunk per y tile
constexpr int kTileRows = kTile / 16;
constexpr int kMaxDim = 128;

// QC, PC, NC: register-tile widths (in 16s) covering Q, hd and S.
template <int QC, int PC, int NC>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                    const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ state_out, int s, int nh, int hd,
                    int G, int S, int Q) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (nh / G);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int T = Q < kTile ? Q : kTile;
  const int Sp = S + 1;
  float* xs = smem;           // [Q, hd]
  float* bs = xs + Q * hd;    // [Q, Sp]
  float* cs = bs + Q * Sp;    // [T, Sp]
  float* ms = cs + T * Sp;    // [T, Q]
  float* st = ms + T * Q;     // [hd, Sp]
  float* acs = st + hd * Sp;  // [Q]
  float* ea = acs + Q;        // [Q] exp(acs)
  float* dte = ea + Q;        // [Q] exp(acs_{Q-1} - acs)

  for (int i = tid; i < hd * Sp; i += kThreads) st[i] = 0.f;

  const int64_t xrow = static_cast<int64_t>(nh) * hd;  // step stride, x/y
  const int64_t brow = static_cast<int64_t>(G) * S;    // step stride, B/C
  const float* xh = x + static_cast<int64_t>(h) * hd;
  float* yh = y + static_cast<int64_t>(h) * hd;
  const float* bg = Bm + static_cast<int64_t>(g) * S;
  const float* cg = Cm + static_cast<int64_t>(g) * S;
  const int n_chunks = s / Q;

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int64_t t0 = static_cast<int64_t>(b) * s +
                       static_cast<int64_t>(ci) * Q;  // first (b, t) row
    for (int i = tid; i < Q * hd; i += kThreads) {
      const int t = i / hd;
      xs[i] = xh[(t0 + t) * xrow + (i - t * hd)];
    }
    for (int i = tid; i < Q * S; i += kThreads) {
      const int t = i / S;
      const int n = i - t * S;
      bs[t * Sp + n] = bg[(t0 + t) * brow + n];
    }
    // inclusive cumsum of a over the chunk: warp 0, 32 steps at a time
    if (tid < 32) {
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int t = base + tid;
        float v = t < Q ? a[(t0 + t) * nh + h] : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (t < Q) acs[t] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float a_end = acs[Q - 1];
    for (int t = tid; t < Q; t += kThreads) {
      ea[t] = expf(acs[t]);
      dte[t] = expf(a_end - acs[t]);
    }

    for (int r0 = 0; r0 < Q; r0 += T) {
      const int rows = Q - r0 < T ? Q - r0 : T;
      const int jend = r0 + rows;  // M[r][j] is 0 for j >= jend
      for (int i = tid; i < rows * S; i += kThreads) {
        const int r = i / S;
        const int n = i - r * S;
        cs[r * Sp + n] = cg[(t0 + r0 + r) * brow + n];
      }
      __syncthreads();

      // M tile: rows r = ty + 16k of the tile, columns j = tx + 16c
      {
        float acc[kTileRows][QC];
#pragma unroll
        for (int k = 0; k < kTileRows; ++k)
#pragma unroll
          for (int c = 0; c < QC; ++c) acc[k][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < S; ++n) {
          float cv[kTileRows], bv[QC];
#pragma unroll
          for (int k = 0; k < kTileRows; ++k) {
            const int r = ty + 16 * k;
            cv[k] = r < rows ? cs[r * Sp + n] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < QC; ++c) {
            const int j = tx + 16 * c;
            bv[c] = j < jend ? bs[j * Sp + n] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kTileRows; ++k)
#pragma unroll
            for (int c = 0; c < QC; ++c)
              acc[k][c] = fmaf(cv[k], bv[c], acc[k][c]);
        }
#pragma unroll
        for (int k = 0; k < kTileRows; ++k) {
          const int r = ty + 16 * k;
          const int i = r0 + r;
#pragma unroll
          for (int c = 0; c < QC; ++c) {
            const int j = tx + 16 * c;
            if (r < rows && j < Q)
              ms[r * Q + j] = j <= i ? expf(acs[i] - acs[j]) * acc[k][c]
                                     : 0.f;
          }
        }
      }
      __syncthreads();

      // y tile: rows r = ty + 16k, columns p = tx + 16c
      {
        float acc[kTileRows][PC];
#pragma unroll
        for (int k = 0; k < kTileRows; ++k)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[k][c] = 0.f;
        // inter-chunk term C . state^T, then scaled by exp(acs)
#pragma unroll 4
        for (int n = 0; n < S; ++n) {
          float cv[kTileRows], sv[PC];
#pragma unroll
          for (int k = 0; k < kTileRows; ++k) {
            const int r = ty + 16 * k;
            cv[k] = r < rows ? cs[r * Sp + n] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int p = tx + 16 * c;
            sv[c] = p < hd ? st[p * Sp + n] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kTileRows; ++k)
#pragma unroll
            for (int c = 0; c < PC; ++c)
              acc[k][c] = fmaf(cv[k], sv[c], acc[k][c]);
        }
#pragma unroll
        for (int k = 0; k < kTileRows; ++k) {
          const int r = ty + 16 * k;
          const float e = r < rows ? ea[r0 + r] : 0.f;
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[k][c] *= e;
        }
        // intra-chunk term M . X
#pragma unroll 4
        for (int j = 0; j < jend; ++j) {
          float mv[kTileRows], xv[PC];
#pragma unroll
          for (int k = 0; k < kTileRows; ++k) {
            const int r = ty + 16 * k;
            mv[k] = r < rows ? ms[r * Q + j] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int p = tx + 16 * c;
            xv[c] = p < hd ? xs[j * hd + p] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kTileRows; ++k)
#pragma unroll
            for (int c = 0; c < PC; ++c)
              acc[k][c] = fmaf(mv[k], xv[c], acc[k][c]);
        }
#pragma unroll
        for (int k = 0; k < kTileRows; ++k) {
          const int r = ty + 16 * k;
          if (r >= rows) continue;
          float* yr = yh + (t0 + r0 + r) * xrow;
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int p = tx + 16 * c;
            if (p < hd) yr[p] = acc[k][c];
          }
        }
      }
      __syncthreads();  // the next tile overwrites cs and ms
    }

    // state update, after every y of the chunk has read the old state
    for (int i = tid; i < Q * S; i += kThreads) {
      const int t = i / S;
      const int n = i - t * S;
      bs[t * Sp + n] *= dte[t];
    }
    __syncthreads();
    {
      const float decay = expf(a_end);
      float acc[PC][NC];
#pragma unroll
      for (int k = 0; k < PC; ++k)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[k][c] = 0.f;
#pragma unroll 4
      for (int t = 0; t < Q; ++t) {
        float xv[PC], bv[NC];
#pragma unroll
        for (int k = 0; k < PC; ++k) {
          const int p = ty + 16 * k;
          xv[k] = p < hd ? xs[t * hd + p] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          bv[c] = n < S ? bs[t * Sp + n] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < PC; ++k)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            acc[k][c] = fmaf(xv[k], bv[c], acc[k][c]);
      }
#pragma unroll
      for (int k = 0; k < PC; ++k) {
        const int p = ty + 16 * k;
        if (p >= hd) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = tx + 16 * c;
          if (n < S) st[p * Sp + n] = decay * st[p * Sp + n] + acc[k][c];
        }
      }
    }
    __syncthreads();  // the next chunk overwrites xs, bs and acs
  }

  float* so = state_out + (static_cast<int64_t>(b) * nh + h) * hd * S;
  for (int i = tid; i < hd * S; i += kThreads) {
    const int p = i / S;
    so[i] = st[p * Sp + (i - p * S)];
  }
}

template <int QC, int PC, int NC>
cudaError_t launch(const float* x, const float* a, const float* B,
                   const float* C, float* y, float* state, int b, int s,
                   int nh, int hd, int G, int S, int Q, size_t smem,
                   cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<QC, PC, NC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(nh, b), kThreads, smem, stream>>>(x, a, B, C, y, state, s,
                                                  nh, hd, G, S, Q);
  return cudaGetLastError();
}

template <int QC, int PC>
cudaError_t launch_n(int S, const float* x, const float* a, const float* B,
                     const float* C, float* y, float* state, int b, int s,
                     int nh, int hd, int G, int Q, size_t smem,
                     cudaStream_t stream) {
  if (S <= 64)
    return launch<QC, PC, 4>(x, a, B, C, y, state, b, s, nh, hd, G, S, Q,
                             smem, stream);
  return launch<QC, PC, 8>(x, a, B, C, y, state, b, s, nh, hd, G, S, Q,
                           smem, stream);
}

template <int QC>
cudaError_t launch_p(int hd, int S, const float* x, const float* a,
                     const float* B, const float* C, float* y, float* state,
                     int b, int s, int nh, int G, int Q, size_t smem,
                     cudaStream_t stream) {
  if (hd <= 64)
    return launch_n<QC, 4>(S, x, a, B, C, y, state, b, s, nh, hd, G, Q,
                           smem, stream);
  return launch_n<QC, 8>(S, x, a, B, C, y, state, b, s, nh, hd, G, Q, smem,
                         stream);
}

}  // namespace

extern "C" {

int ssd_scan_f32(const void* x, const void* a_log, const void* Bm,
                 const void* Cm, void* y, void* state, int b, int s, int nh,
                 int hd, int G, int S, int Q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0 || s <= 0 || nh <= 0) return 0;
  if (Q <= 0 || Q > kMaxDim || s % Q != 0 || hd <= 0 || hd > kMaxDim ||
      S <= 0 || S > kMaxDim || G <= 0 || nh % G != 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = Q < kTile ? Q : kTile;
  const size_t smem =
      sizeof(float) *
      (static_cast<size_t>(Q) * hd + static_cast<size_t>(Q) * (S + 1) +
       static_cast<size_t>(T) * (S + 1) + static_cast<size_t>(T) * Q +
       static_cast<size_t>(hd) * (S + 1) + 3 * static_cast<size_t>(Q));
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
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q <= 64)
    err = launch_p<4>(hd, S, xf, af, bf, cf, yf, sf, b, s, nh, G, Q, smem,
                      st);
  else
    err = launch_p<8>(hd, S, xf, af, bf, cf, yf, sf, b, s, nh, G, Q, smem,
                      st);
  return static_cast<int>(err);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
