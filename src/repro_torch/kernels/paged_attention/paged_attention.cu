// One-token GQA decode attention over a paged KV cache.
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
// Bound on an H100: bytes.  Each launch must read every K and V row it
// attends to once, 2 * sum_b ctx_b * K * hd * 4 bytes in fp32, against
// about 2 * g flops per byte: far below the card's flop-per-byte ridge.
//
// Design: one block per (KV head, sequence), so the K and V rows of that
// head are read from HBM exactly once and serve all g query heads.  The
// block walks only ceil(ctx / ps) pages (the TPU grid walks every entry
// of the block table, padding included).  Per page it stages the
// [ps, hd] K and V tiles in shared memory with 128-bit loads, computes
// the g x ps logits with groups of 8 threads per dot product (shuffle
// reduction, bank-rotated so the 4 groups of a warp hit distinct banks),
// updates the fp32 online-softmax state (m, l) with one warp per query
// head, and accumulates P.V into an fp32 accumulator in shared memory.
// The running max starts at -inf and a masked position weighs exactly 0:
// the TPU kernel starts at -1e30, which gives a fully masked tile a
// weight of exp(0) = 1 and is safe there only because page 0 always
// holds a valid key.  A block-table entry outside [0, P) makes the
// block write NaN for its heads instead of reading out of bounds.
// What this simple design leaves on the table (for a later change):
// the loads are not overlapped with the math (no cp.async/TMA ring), and
// with B * K blocks < 132 SMs the page axis is not split across blocks
// (flash-decoding).
//
// C interface (ctypes): paged_attention_f32 returns a cudaError_t as int,
// 0 on success; the launch goes to the caller's stream, unsynchronised.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 8;  // threads per logit dot product

__global__ void paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ lens, float* __restrict__ out, int H, int K,
    int hd, int P, int ps, int bps, float scale) {
  extern __shared__ float smem[];
  const int g = H / K;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  float* q_s = smem;                // [g, hd]
  float* k_s = q_s + g * hd;        // [ps, hd]
  float* v_s = k_s + ps * hd;       // [ps, hd]
  float* p_s = v_s + ps * hd;       // [g, ps] logits, then weights
  float* acc_s = p_s + g * ps;      // [g, hd]
  float* m_s = acc_s + g * hd;      // [g]
  float* l_s = m_s + g;             // [g]
  float* a_s = l_s + g;             // [g] rescale of the running sums
  __shared__ int bad;

  const int ctx = lens[b];
  const float* qb = q + (static_cast<int64_t>(b) * H + kh * g) * hd;
  for (int i = tid; i < g * hd; i += nt) {
    q_s[i] = qb[i];
    acc_s[i] = 0.f;
  }
  for (int j = tid; j < g; j += nt) {
    m_s[j] = -INFINITY;
    l_s[j] = 0.f;
  }
  int n_pages = ctx > 0 ? (ctx + ps - 1) / ps : 0;
  if (tid == 0) bad = n_pages > bps;
  if (n_pages > bps) n_pages = bps;
  __syncthreads();

  const int vec4 = hd / 4;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const int gl = lane % kGroup;                // lane inside its group
  const int rot = ((lane / kGroup) * kGroup) % hd;  // bank rotation
  const int group = tid / kGroup;
  const int n_groups = nt / kGroup;
  const int n_pairs = g * ps;
  const int pair_rounds = (n_pairs + n_groups - 1) / n_groups;

  for (int jp = 0; jp < n_pages; ++jp) {
    const int page = tables[static_cast<int64_t>(b) * bps + jp];
    if (page < 0 || page >= P) {  // same value in every thread: uniform
      if (tid == 0) bad = 1;
      break;
    }
    // stage this page's K and V rows of KV head kh
    for (int i = tid; i < ps * vec4; i += nt) {
      const int t = i / vec4;
      const int c = i - t * vec4;
      const int64_t off =
          ((static_cast<int64_t>(page) * ps + t) * K + kh) * hd + 4 * c;
      reinterpret_cast<float4*>(k_s)[i] =
          *reinterpret_cast<const float4*>(k_pages + off);
      reinterpret_cast<float4*>(v_s)[i] =
          *reinterpret_cast<const float4*>(v_pages + off);
    }
    __syncthreads();

    // logits: one group of 8 threads per (query head j, position t)
    for (int r = 0; r < pair_rounds; ++r) {
      const int pair = r * n_groups + group;
      const bool active = pair < n_pairs;
      const int j = active ? pair / ps : 0;
      const int t = active ? pair - j * ps : 0;
      float part = 0.f;
      if (active) {
        const float* qr = q_s + j * hd;
        const float* kr = k_s + t * hd;
        for (int d0 = 0; d0 < hd; d0 += kGroup) {
          int d = d0 + rot;
          if (d >= hd) d -= hd;
          d += gl;  // d0 + rot < 2 * hd: one wrap at most
          part += qr[d] * kr[d];
        }
      }
      for (int off = kGroup / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (active && gl == 0) {
        const int pos = jp * ps + t;
        p_s[pair] = pos < ctx ? part * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int j = warp; j < g; j += n_warps) {
      const float m_old = m_s[j];
      float mx = -INFINITY;
      for (int t = lane; t < ps; t += 32) mx = fmaxf(mx, p_s[j * ps + t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < ps; t += 32) {
        const float lg = p_s[j * ps + t];
        const float p = lg == -INFINITY ? 0.f : expf(lg - m_new);
        p_s[j * ps + t] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        m_s[j] = m_new;
        l_s[j] = l_s[j] * alpha + sum;
        a_s[j] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
    for (int i = tid; i < g * hd; i += nt) {
      const int j = i / hd;
      const int d = i - j * hd;
      float acc = acc_s[i] * a_s[j];
      for (int t = 0; t < ps; ++t) acc += p_s[j * ps + t] * v_s[t * hd + d];
      acc_s[i] = acc;
    }
    __syncthreads();
  }
  __syncthreads();  // a bad page may have ended the loop early

  float* ob = out + (static_cast<int64_t>(b) * H + kh * g) * hd;
  for (int i = tid; i < g * hd; i += nt) {
    const int j = i / hd;
    ob[i] = bad ? NAN : acc_s[i] / fmaxf(l_s[j], 1e-30f);
  }
}

}  // namespace

extern "C" {

int paged_attention_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* context_lens, void* out, int B, int H,
                        int K, int hd, int P, int ps, int bps, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  const int g = H / K;
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(g) * hd +
                       2 * static_cast<size_t>(ps) * hd +
                       static_cast<size_t>(g) * ps + 3 * g);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(paged_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(K, B);
  paged_attention_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages),
      static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(context_lens), static_cast<float*>(out), H,
      K, hd, P, ps, bps, 1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
