// One-token GQA decode attention over a paged KV cache, split along the
// page axis (flash-decoding) with the page loads pipelined.
//
// Replaces: src/repro/kernels/paged_attention/paged_attention.py::
// paged_attention_pallas (the TPU kernel: grid (B, pages_per_seq), one
// page per sequential grid step, online-softmax state in VMEM scratch).
//
//   out[b, h] = softmax_t(q[b, h] . k[b, t] / sqrt(hd)) . v[b, t]
//   over the positions t < context_lens[b] of sequence b, whose keys and
//   values sit in pages block_tables[b, t / ps], row t % ps; query head h
//   reads KV head h / g (g = H / K query heads share one KV head).
//
// Bound on an H100: bytes.  A call must read every K and V row it
// attends to once, 2 * sum_b ctx_b * K * hd * 4 bytes in fp32, against
// about 2 * g flops per byte: far below the card's flop-per-byte ridge.
// Reaching the HBM rate takes tens of kilobytes in flight on every SM,
// and a decode batch has few (sequence, KV head) pairs: B * K = 96 at
// lwm-7b with three sequences, 24 at yi-34b, for 132 SMs.
//
// Design.
// - Split: the grid is (K * head tiles, B, n_split).  The wrapper picks
//   n_split from B * K and the table width so that about two blocks run
//   on every SM (ops.py::plan_splits).  Block s of a sequence with n
//   valid pages takes the contiguous logical pages
//   [s * ceil(n / n_split), min(n, (s + 1) * ceil(n / n_split))), so the
//   splits of one sequence share its work evenly and a split past the
//   end is empty.  Each block reads its K/V rows once for all (up to 8)
//   query heads of its KV head; g > 8 takes several head tiles.
// - Loads: each of the 4 warps streams its own rows (4 rows per step,
//   steps dealt round-robin to the warps) through a private 4-stage
//   cp.async ring in shared memory, 16 bytes per lane, so three steps of
//   K and V rows are in flight while the warp computes on the fourth.
//   A lane reads back only the bytes it copied, so the ring needs no
//   barrier at all: cp.async.wait_group alone orders it.  The block
//   reads its sequence's length, its table row and q in one round trip.
//   q and the running (m, l, acc) of every head live in registers; a
//   logit is a lane-parallel dot product reduced with warp shuffles.
// - Merge: the four warps' states are combined in shared memory.  With
//   one split the block writes the output; otherwise it writes its
//   partial (m, l, acc[g, hd]) in fp32 to scratch the wrapper allocates,
//   and a second kernel (one warp per (sequence, query head)) merges the
//   splits with the rescale exp(m_i - m).  An empty split writes m =
//   -inf, l = 0 and weighs exactly 0 (never exp(-inf - -inf)).
// - Masking: the running max starts at -inf and positions >= ctx are
//   never loaded.  A block-table entry outside [0, P) in any split, or a
//   context longer than the table, turns that sequence's heads into NaN
//   (the split writes m = NaN, which the merge propagates) instead of
//   reading out of bounds.
// What still holds it (PERF.md): at lwm-7b's heads it streams at about
// two thirds of the HBM rate, plus the merge launch; at yi-34b's, each
// block has only ~3 pages, so the length/table/q round trip, one ring
// fill and the second launch set its time, not the bytes.
//
// C interface (ctypes): paged_attention_f32 returns a cudaError_t as int,
// 0 on success; the launches go to the caller's stream, unsynchronised.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;        // rows per warp per pipeline step
constexpr int kStages = 4;      // cp.async ring depth per warp
constexpr int kHeadTile = 8;    // query heads served by one block
constexpr int kAccOff = 2 * kHeadTile;  // parked acc after m and l

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// G: query heads held in registers (>= the tile's heads); NV: float4
// chunks of a row per lane (hd <= 128 * NV).
template <int G, int NV>
__global__ void __launch_bounds__(kThreads)
    paged_attention_split_kernel(
        const float* __restrict__ q, const float* __restrict__ k_pages,
        const float* __restrict__ v_pages, const int32_t* __restrict__ tables,
        const int32_t* __restrict__ lens, float* __restrict__ out,
        float* __restrict__ part_ml, float* __restrict__ part_acc, int B,
        int H, int K, int hd, int P, int ps, int bps, int n_htile,
        float scale) {
  extern __shared__ __align__(16) float smem[];
  const int g = H / K;
  const int kh = blockIdx.x / n_htile;
  const int ht = blockIdx.x - kh * n_htile;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int head0 = kh * g + ht * kHeadTile;
  const int gt = min(g - ht * kHeadTile, kHeadTile);  // heads in the tile
  const int C = hd / 4;                               // float4 per row
  const int ring = kStages * 2 * kRows * hd;          // floats per warp
  float* wring = smem + warp * ring;
  int* tab_s = reinterpret_cast<int*>(smem + kWarps * ring);

  // one round trip: the length, the whole table row and q, all at once
  const int ctx = lens[b];
  for (int i = tid; i < bps; i += kThreads)
    tab_s[i] = tables[static_cast<int64_t>(b) * bps + i];
  const int64_t row_base = static_cast<int64_t>(b) * H + head0;
  float4 qv[G][NV];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = lane + 32 * v;
      qv[j][v] = (j < gt && c < C)
                     ? *reinterpret_cast<const float4*>(
                           q + (row_base + j) * hd + 4 * c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  int n_pages = ctx > 0 ? (ctx + ps - 1) / ps : 0;
  const bool bad_len = n_pages > bps;
  if (bad_len) n_pages = bps;
  const int pps = (n_pages + n_split - 1) / n_split;
  const int p_start = min(sp * pps, n_pages);
  const int p_end = min(p_start + pps, n_pages);
  __syncthreads();
  int bad = 0;
  for (int i = p_start + tid; i < p_end; i += kThreads)
    bad |= tab_s[i] < 0 || tab_s[i] >= P;
  bad = __syncthreads_or(bad) || bad_len;

  if (bad) {
    for (int i = tid; i < gt * hd; i += kThreads) {
      if (n_split == 1) {
        out[row_base * hd + i] = NAN;
      } else {
        const int64_t r = (static_cast<int64_t>(sp) * B * H) + row_base;
        part_acc[r * hd + i] = 0.f;
        if (i % hd == 0) {
          part_ml[2 * (r + i / hd)] = NAN;
          part_ml[2 * (r + i / hd) + 1] = 0.f;
        }
      }
    }
    return;
  }

  const int row0 = p_start * ps;
  const int row1 = min(p_end * ps, ctx);
  const int n_rows = row1 > row0 ? row1 - row0 : 0;
  const int n_steps = (n_rows + kRows * kWarps - 1) / (kRows * kWarps);

  float4 acc[G][NV];
  float m[G], l[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[j][v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // step i of this warp covers rows row0 + (i * kWarps + warp) * kRows + r
  auto issue = [&](int step) {
    float* slot = wring + (step % kStages) * 2 * kRows * hd;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + (step * kWarps + warp) * kRows + r;
      if (row >= row1) break;
      const int lp = row / ps;
      const int t = row - lp * ps;
      const int64_t off =
          ((static_cast<int64_t>(tab_s[lp]) * ps + t) * K + kh) *
          hd;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c = lane + 32 * v;
        if (c < C) {
          cp_async16(slot + r * hd + 4 * c, k_pages + off + 4 * c);
          cp_async16(slot + (kRows + r) * hd + 4 * c, v_pages + off + 4 * c);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    if (i + kStages - 1 < n_steps) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this lane's copies of step i landed
    const float* slot = wring + (i % kStages) * 2 * kRows * hd;
    const int first = row0 + (i * kWarps + warp) * kRows;
    const int nr = min(kRows, row1 - first);  // warp-uniform, may be <= 0
    float sc[G][kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) {
        float4 kv[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = lane + 32 * v;
          kv[v] = c < C ? *reinterpret_cast<const float4*>(slot + r * hd +
                                                           4 * c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          float part = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v)
            part += qv[j][v].x * kv[v].x + qv[j][v].y * kv[v].y +
                    qv[j][v].z * kv[v].z + qv[j][v].w * kv[v].w;
          sc[j][r] = warp_sum(part) * scale;
        }
      } else {
#pragma unroll
        for (int j = 0; j < G; ++j) sc[j][r] = -INFINITY;
      }
    }
    if (nr > 0) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float mx = sc[j][0];
#pragma unroll
        for (int r = 1; r < kRows; ++r) mx = fmaxf(mx, sc[j][r]);
        const float m_new = fmaxf(m[j], mx);  // finite: row 0 is valid
        const float alpha = expf(m[j] - m_new);  // exp(-inf) = 0
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = r < nr ? expf(sc[j][r] - m_new) : 0.f;
          sc[j][r] = p;
          sum += p;
        }
        m[j] = m_new;
        l[j] = l[j] * alpha + sum;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          acc[j][v].x *= alpha;
          acc[j][v].y *= alpha;
          acc[j][v].z *= alpha;
          acc[j][v].w *= alpha;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nr) break;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c = lane + 32 * v;
          if (c >= C) continue;
          const float4 vv = *reinterpret_cast<const float4*>(
              slot + (kRows + r) * hd + 4 * c);
#pragma unroll
          for (int j = 0; j < G; ++j) {
            const float p = sc[j][r];
            acc[j][v].x += p * vv.x;
            acc[j][v].y += p * vv.y;
            acc[j][v].z += p * vv.z;
            acc[j][v].w += p * vv.w;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  // each warp parks its state in its own ring: [G] m, [G] l, then from
  // float 16 (16-byte aligned) [G, hd] acc
  float* wm = wring;
  float* wl = wring + G;
  float* wacc = wring + kAccOff;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (lane == 0) {
      wm[j] = m[j];
      wl[j] = l[j];
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c = lane + 32 * v;
      if (c < C) *reinterpret_cast<float4*>(wacc + j * hd + 4 * c) = acc[j][v];
    }
  }
  __syncthreads();

  for (int i = tid; i < gt * C; i += kThreads) {
    const int j = i / C;
    const int c = i - j * C;
    float mb = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mb = fmaxf(mb, smem[w * ring + j]);
    float lb = 0.f;
    float4 ab = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* base = smem + w * ring;
      const float mw = base[j];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - mb);
      const float4 a =
          *reinterpret_cast<const float4*>(base + kAccOff + j * hd + 4 * c);
      lb += wt * base[G + j];
      ab.x += wt * a.x;
      ab.y += wt * a.y;
      ab.z += wt * a.z;
      ab.w += wt * a.w;
    }
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(lb, 1e-30f);
      *reinterpret_cast<float4*>(out + (row_base + j) * hd + 4 * c) =
          make_float4(ab.x * inv, ab.y * inv, ab.z * inv, ab.w * inv);
    } else {
      const int64_t r = static_cast<int64_t>(sp) * B * H + row_base + j;
      *reinterpret_cast<float4*>(part_acc + r * hd + 4 * c) = ab;
      if (c == 0) {
        part_ml[2 * r] = mb;
        part_ml[2 * r + 1] = lb;
      }
    }
  }
}

// one warp per (sequence, query head) row: merge the n_split partials.
// The lanes read the splits' (m, l) 32 at a time; the acc loads of
// consecutive splits are independent, so several are in flight at once.
__global__ void __launch_bounds__(kThreads)
    paged_attention_merge_kernel(const float* __restrict__ part_ml,
                                 const float* __restrict__ part_acc,
                                 float* __restrict__ out, int rows, int hd,
                                 int n_split) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // warp-uniform
  float mb = -INFINITY;
  bool bad = false;
  for (int s = lane; s < n_split; s += 32) {
    const float ms = part_ml[2 * (static_cast<int64_t>(s) * rows + row)];
    bad |= isnan(ms);
    mb = fmaxf(mb, ms);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
  bad = __any_sync(0xffffffffu, bad);
  float lb = 0.f;
  for (int s = lane; s < n_split; s += 32) {
    const int64_t r = static_cast<int64_t>(s) * rows + row;
    const float ms = part_ml[2 * r];
    lb += (ms == -INFINITY ? 0.f : expf(ms - mb)) * part_ml[2 * r + 1];
  }
  const float inv = 1.f / fmaxf(warp_sum(lb), 1e-30f);
  const int C = hd / 4;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float4 ab = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_split; s0 += 32) {
      float wl = 0.f;  // weight of split s0 + lane
      if (s0 + lane < n_split) {
        const float ms =
            part_ml[2 * (static_cast<int64_t>(s0 + lane) * rows + row)];
        wl = ms == -INFINITY ? 0.f : expf(ms - mb);
      }
      const int ns = min(32, n_split - s0);
#pragma unroll 4
      for (int k = 0; k < ns; ++k) {
        const float wt = __shfl_sync(0xffffffffu, wl, k);
        if (c < C) {
          const float4 a = *reinterpret_cast<const float4*>(
              part_acc + (static_cast<int64_t>(s0 + k) * rows + row) * hd +
              4 * c);
          ab.x += wt * a.x;
          ab.y += wt * a.y;
          ab.z += wt * a.z;
          ab.w += wt * a.w;
        }
      }
    }
    if (c < C)
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * hd +
                                 4 * c) =
          bad ? make_float4(NAN, NAN, NAN, NAN)
              : make_float4(ab.x * inv, ab.y * inv, ab.z * inv, ab.w * inv);
  }
}

template <int G, int NV>
cudaError_t launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                         const float* q, const float* kp, const float* vp,
                         const int32_t* bt, const int32_t* cl, float* out,
                         float* ml, float* acc, int B, int H, int K, int hd,
                         int P, int ps, int bps, int n_htile, float scale) {
  auto kernel = paged_attention_split_kernel<G, NV>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(q, kp, vp, bt, cl, out, ml, acc,
                                           B, H, K, hd, P, ps, bps, n_htile,
                                           scale);
  return cudaGetLastError();
}

template <int NV>
cudaError_t launch_g(int G, dim3 grid, size_t smem, cudaStream_t stream,
                     const float* q, const float* kp, const float* vp,
                     const int32_t* bt, const int32_t* cl, float* out,
                     float* ml, float* acc, int B, int H, int K, int hd, int P,
                     int ps, int bps, int n_htile, float scale) {
  switch (G) {
    case 1:
      return launch_split<1, NV>(grid, smem, stream, q, kp, vp, bt, cl, out,
                                 ml, acc, B, H, K, hd, P, ps, bps, n_htile,
                                 scale);
    case 2:
      return launch_split<2, NV>(grid, smem, stream, q, kp, vp, bt, cl, out,
                                 ml, acc, B, H, K, hd, P, ps, bps, n_htile,
                                 scale);
    case 4:
      return launch_split<4, NV>(grid, smem, stream, q, kp, vp, bt, cl, out,
                                 ml, acc, B, H, K, hd, P, ps, bps, n_htile,
                                 scale);
    default:
      return launch_split<8, NV>(grid, smem, stream, q, kp, vp, bt, cl, out,
                                 ml, acc, B, H, K, hd, P, ps, bps, n_htile,
                                 scale);
  }
}

}  // namespace

extern "C" {

// scratch: n_split * B * H * (hd + 2) floats when n_split > 1 (acc, then
// m and l), else unused
int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* context_lens, void* out, void* scratch,
                        int B, int H, int K, int hd, int P, int ps, int bps,
                        int n_split, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (K <= 0 || H % K != 0 || hd <= 0 || hd % 4 != 0 || hd > 256 ||
      n_split < 1 || B > 65535 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = H / K;
  const int n_htile = (g + kHeadTile - 1) / kHeadTile;
  const int gt = g < kHeadTile ? g : kHeadTile;
  const int G = gt <= 1 ? 1 : gt <= 2 ? 2 : gt <= 4 ? 4 : 8;
  const size_t smem = sizeof(float) * kWarps * kStages * 2 * kRows *
                          static_cast<size_t>(hd) +
                      sizeof(int32_t) * static_cast<size_t>(bps > 0 ? bps : 1);
  const dim3 grid(K * n_htile, B, n_split);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pages);
  const float* vf = static_cast<const float*>(v_pages);
  const int32_t* bt = static_cast<const int32_t*>(block_tables);
  const int32_t* cl = static_cast<const int32_t*>(context_lens);
  float* of = static_cast<float*>(out);
  const int rows = B * H;
  float* acc = static_cast<float*>(scratch);  // first: 16-byte aligned
  float* ml = acc + static_cast<size_t>(n_split) * rows * hd;
  if (hd <= 128)
    err = launch_g<1>(G, grid, smem, st, qf, kf, vf, bt, cl, of, ml, acc, B,
                      H, K, hd, P, ps, bps, n_htile, scale);
  else
    err = launch_g<2>(G, grid, smem, st, qf, kf, vf, bt, cl, of, ml, acc, B,
                      H, K, hd, P, ps, bps, n_htile, scale);
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  paged_attention_merge_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                                 st>>>(ml, acc, of, rows, hd, n_split);
  return static_cast<int>(cudaGetLastError());
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
