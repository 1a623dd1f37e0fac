// The routed experts of a dropless MoE layer on the card: every (token,
// expert) choice computed, none dropped, each expert reading its weights
// only if a token chose it.
//
// Replaces no TPU kernel: the JAX package's MoE layer (src/repro/models/
// moe.py::apply_moe) is plain XLA over an [E, capacity] dispatch table, and
// so was the port's (src/repro_torch/models/moe.py::apply_moe), which runs
// all E experts over their capacity slots and drops the choices past them.
// On the serving path (serving/paged_model.py::_mlp_out, a config with
// moe_dropless) this op takes its place.
//
// Three launches on the caller's stream, no host synchronisation:
//   1. moe_sort_kernel (one block): a stable counting sort of the P = n * k
//      choices by expert: per-expert counts, offsets, `order` (the choice at
//      each sorted row) and a list of row tiles, a tile being up to BM rows
//      of one expert; an expert with no choice gets no tile.  meta[0] is the
//      number of tiles, meta[1] the number of experts chosen.
//   2. the gate-up product: h[r] = silu(x[t] @ Wg[e]) * (x[t] @ Wu[e]) for
//      each sorted row r of expert e and token t = order[r] / k, written in
//      sorted order [P, ff].
//   3. the down product: y[order[r]] = w[order[r]] * (h[r] @ Wo[e]), written
//      at the choice's own row [P, d] (token-major), so the caller's combine
//      sums each token's k rows in a fixed order: the result does not depend
//      on the sort or on the blocks' timing.
// The grid of 2 and 3 is sized from the host's bound on the tiles
// (P // BM + min(E, P)); blocks past meta[0] return at once.
//
// Bound on an H100 (fp32, no tensor cores, TF32 off): the expert weights
// (3 x d x ff x 4 B an expert, 34.6 MB at deepseek-moe-16b's d 2048, ff
// 1408) against 2 x 3 x d x ff operations a choice.  At batch-1 decode a
// layer's 6 experts are 208 MB, 62 us of HBM time and 0.5 us of operations;
// a 256-token suffix reaches every expert (2.2 GB, 661 us) with 26.6 GFLOP
// (397 us); a 1,024-token prefill is bound by operations (106 GFLOP, 1.6 ms).
// So the design serves both ends:
//   - a skinny variant (tiles of at most 8 rows, for P < 16 E) streams each
//     weight once per tile: a block takes 64 output columns (two a lane) of
//     one tile, its 8 warps split the depth, each lane keeps eight 8-byte
//     weight loads in flight, and the warps' partial sums meet in shared
//     memory in a fixed order.  A batch-1 decode layer is 132 blocks of
//     gate-up and 192 of down;
//   - a tiled variant (32- or 64-row tiles, 256 threads, a 64-column block,
//     depth 16 a step, a register-staged double buffer in shared memory,
//     4 x 4 or 2 x 4 outputs a thread, both of gate and up in the gate-up
//     launch) for prefills, where each expert's rows share its weights.
//
// C interface (ctypes): moe_experts returns a cudaError_t as int, 0 on
// success; the launches go to the caller's stream and are not synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SORT_THREADS = 1024;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int MAX_EXPERTS = 256;

__global__ void __launch_bounds__(SORT_THREADS)
moe_sort_kernel(const int64_t* __restrict__ ids, int P, int E, int bm,
                int32_t* __restrict__ order, int32_t* __restrict__ offsets,
                int32_t* __restrict__ tile_e, int32_t* __restrict__ tile_r,
                int32_t* __restrict__ meta) {
  __shared__ int count[MAX_EXPERTS];
  __shared__ int cursor[MAX_EXPERTS];
  __shared__ int first_tile[MAX_EXPERTS];
  __shared__ int wcount[SORT_WARPS][MAX_EXPERTS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < E; i += SORT_THREADS) count[i] = 0;
  for (int i = tid; i < SORT_WARPS * MAX_EXPERTS; i += SORT_THREADS)
    (&wcount[0][0])[i] = 0;
  __syncthreads();
  for (int i = tid; i < P; i += SORT_THREADS)
    atomicAdd(&count[static_cast<int>(ids[i])], 1);
  __syncthreads();
  if (tid == 0) {
    int row = 0, tiles = 0, used = 0;
    for (int e = 0; e < E; ++e) {
      const int c = count[e];
      offsets[e] = row;
      cursor[e] = row;
      first_tile[e] = tiles;
      row += c;
      tiles += (c + bm - 1) / bm;
      used += c > 0;
    }
    offsets[E] = row;
    meta[0] = tiles;
    meta[1] = used;
  }
  __syncthreads();
  for (int e = tid; e < E; e += SORT_THREADS) {
    const int c = count[e], t0 = first_tile[e], r0 = cursor[e];
    for (int j = 0; j * bm < c; ++j) {
      tile_e[t0 + j] = e;
      tile_r[t0 + j] = r0 + j * bm;
    }
  }
  // the scatter, SORT_THREADS choices a round: a choice's row is its
  // expert's cursor, plus the choices of that expert in the lower warps of
  // the round, plus its rank among its warp's lanes of that expert
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < P; base += SORT_THREADS) {
    const int i = base + tid;
    const int e = i < P ? static_cast<int>(ids[i]) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(same & below);
    const bool leader = rank == 0;
    if (e >= 0 && leader) wcount[warp][e] = __popc(same);
    __syncthreads();
    if (e >= 0) {
      int pos = cursor[e] + rank;
      for (int w = 0; w < warp; ++w) pos += wcount[w][e];
      order[pos] = i;
    }
    __syncthreads();
    for (int x = tid; x < E; x += SORT_THREADS) {
      int add = 0;
      for (int w = 0; w < SORT_WARPS; ++w) add += wcount[w][x];
      cursor[x] += add;
    }
    __syncthreads();
    if (e >= 0 && leader) wcount[warp][e] = 0;
    __syncthreads();
  }
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// -- skinny variant: tiles of at most SK_ROWS rows -----------------------------

constexpr int SK_ROWS = 8;
constexpr int SK_WARPS = 8;
constexpr int SK_COLS = 64;  // two a lane

// GATEUP: a = x [n, K], w = wi [E, K, 2, N], out = h [P, N] (sorted rows);
// else:   a = h [P, K], w = wo [E, K, N],   out = y [P, N] (choice rows).
template <bool GATEUP>
__global__ void __launch_bounds__(SK_WARPS * 32)
moe_skinny_kernel(const float* __restrict__ a, const float* __restrict__ w,
                  const float* __restrict__ wts,
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ tile_e,
                  const int32_t* __restrict__ tile_r,
                  const int32_t* __restrict__ meta, int k, int K, int N,
                  float* __restrict__ out) {
  constexpr int NB = GATEUP ? 2 : 1;
  __shared__ float red[SK_WARPS][SK_ROWS][NB * SK_COLS];
  const int t = blockIdx.x;
  if (t >= meta[0]) return;
  const int e = tile_e[t], r0 = tile_r[t];
  const int rows = min(SK_ROWS, offsets[e + 1] - r0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.y * SK_COLS + 2 * lane;
  const size_t ldw = GATEUP ? 2 * static_cast<size_t>(N)
                            : static_cast<size_t>(N);
  const float* wb = w + static_cast<size_t>(e) * K * ldw + col;
  const float* arow[SK_ROWS];
#pragma unroll
  for (int m = 0; m < SK_ROWS; ++m) {
    const int r = r0 + min(m, rows - 1);
    arow[m] = a + static_cast<size_t>(GATEUP ? order[r] / k : r) * K;
  }
  float2 acc[NB][SK_ROWS];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int m = 0; m < SK_ROWS; ++m) acc[b][m] = make_float2(0.f, 0.f);
  const int span = K / SK_WARPS, k0 = warp * span;
#pragma unroll 2
  for (int kk = k0; kk < k0 + span; kk += 4) {
    float2 wv[4][NB];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* wr = wb + static_cast<size_t>(kk + j) * ldw;
      wv[j][0] = __ldg(reinterpret_cast<const float2*>(wr));
      if (GATEUP) wv[j][NB - 1] = __ldg(reinterpret_cast<const float2*>(wr + N));
    }
#pragma unroll
    for (int m = 0; m < SK_ROWS; ++m) {
      if (m < rows) {
        const float4 av = *reinterpret_cast<const float4*>(arow[m] + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = lane_of(av, j);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            acc[b][m].x = fmaf(xv, wv[j][b].x, acc[b][m].x);
            acc[b][m].y = fmaf(xv, wv[j][b].y, acc[b][m].y);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SK_ROWS; ++m) {
    if (m < rows) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        red[warp][m][b * SK_COLS + 2 * lane] = acc[b][m].x;
        red[warp][m][b * SK_COLS + 2 * lane + 1] = acc[b][m].y;
      }
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < rows * SK_COLS; o += SK_WARPS * 32) {
    const int m = o / SK_COLS, c = o % SK_COLS;
    float s[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      s[b] = 0.f;
      for (int q = 0; q < SK_WARPS; ++q) s[b] += red[q][m][b * SK_COLS + c];
    }
    const int r = r0 + m, n = blockIdx.y * SK_COLS + c;
    if (GATEUP) {
      out[static_cast<size_t>(r) * N + n] = silu(s[0]) * s[NB - 1];
    } else {
      const int pair = order[r];
      out[static_cast<size_t>(pair) * N + n] = wts[pair] * s[0];
    }
  }
}

// -- tiled variant: tiles of BM rows, 64 columns, depth 16 a step ------------

constexpr int TL_THREADS = 256;
constexpr int TL_BN = 64;
constexpr int TL_BK = 16;

template <int BM, bool GATEUP>
__global__ void __launch_bounds__(TL_THREADS)
moe_tiled_kernel(const float* __restrict__ a, const float* __restrict__ w,
                 const float* __restrict__ wts,
                 const int32_t* __restrict__ order,
                 const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ tile_e,
                 const int32_t* __restrict__ tile_r,
                 const int32_t* __restrict__ meta, int k, int K, int N,
                 float* __restrict__ out) {
  constexpr int NB = GATEUP ? 2 : 1;
  constexpr int TM = BM / 16, TN = 4;  // 16 x 16 threads
  static_assert(BM % 16 == 0 && BM * 4 <= TL_THREADS, "tile rows");
  __shared__ __align__(16) float As[2][TL_BK][BM];
  __shared__ __align__(16) float Bs[2][NB][TL_BK][TL_BN];
  __shared__ int src[BM];
  const int t = blockIdx.x;
  if (t >= meta[0]) return;
  const int e = tile_e[t], r0 = tile_r[t];
  const int rows = min(BM, offsets[e + 1] - r0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.y * TL_BN;
  const size_t ldw = GATEUP ? 2 * static_cast<size_t>(N)
                            : static_cast<size_t>(N);
  const float* wb = w + static_cast<size_t>(e) * K * ldw + n0;
  if (tid < BM)
    src[tid] = tid < rows ? (GATEUP ? order[r0 + tid] / k : r0 + tid) : -1;
  __syncthreads();
  // loaders: A one float4 (a row's 4 depths) for the first BM * 4 threads,
  // B one float4 a matrix for every thread
  const int a_row = tid / 4, a_c4 = tid % 4;
  const int b_k = tid / 16, b_c4 = tid % 16;
  const bool a_loader = tid < BM * 4;
  const int a_src = a_loader ? src[a_row] : -1;
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 rb[NB];
  auto load = [&](int k0) {
    if (a_src >= 0)
      ra = *reinterpret_cast<const float4*>(
          a + static_cast<size_t>(a_src) * K + k0 + a_c4 * 4);
#pragma unroll
    for (int b = 0; b < NB; ++b)
      rb[b] = __ldg(reinterpret_cast<const float4*>(
          wb + static_cast<size_t>(k0 + b_k) * ldw + b * N + b_c4 * 4));
  };
  auto store = [&](int buf) {
    if (a_loader) {
      As[buf][a_c4 * 4 + 0][a_row] = ra.x;
      As[buf][a_c4 * 4 + 1][a_row] = ra.y;
      As[buf][a_c4 * 4 + 2][a_row] = ra.z;
      As[buf][a_c4 * 4 + 3][a_row] = ra.w;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      *reinterpret_cast<float4*>(&Bs[buf][b][b_k][b_c4 * 4]) = rb[b];
  };
  float acc[NB][TM][TN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[b][m][n] = 0.f;
  load(0);
  store(0);
  __syncthreads();
  int cur = 0;
  for (int k0 = 0; k0 < K; k0 += TL_BK) {
    const bool more = k0 + TL_BK < K;
    if (more) load(k0 + TL_BK);
#pragma unroll
    for (int kk = 0; kk < TL_BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) av[m] = As[cur][kk][ty * TM + m];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&Bs[cur][b][kk][tx * TN]);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          acc[b][m][0] = fmaf(av[m], bv.x, acc[b][m][0]);
          acc[b][m][1] = fmaf(av[m], bv.y, acc[b][m][1]);
          acc[b][m][2] = fmaf(av[m], bv.z, acc[b][m][2]);
          acc[b][m][3] = fmaf(av[m], bv.w, acc[b][m][3]);
        }
      }
    }
    if (more) store(cur ^ 1);
    __syncthreads();
    cur ^= 1;
  }
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int local = ty * TM + m;
    if (local >= rows) continue;
    const int r = r0 + local, n = n0 + tx * TN;
    float4 o;
    if (GATEUP) {
      o = make_float4(silu(acc[0][m][0]) * acc[NB - 1][m][0],
                      silu(acc[0][m][1]) * acc[NB - 1][m][1],
                      silu(acc[0][m][2]) * acc[NB - 1][m][2],
                      silu(acc[0][m][3]) * acc[NB - 1][m][3]);
      *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * N + n) = o;
    } else {
      const int pair = order[r];
      const float wv = wts[pair];
      o = make_float4(wv * acc[0][m][0], wv * acc[0][m][1],
                      wv * acc[0][m][2], wv * acc[0][m][3]);
      *reinterpret_cast<float4*>(out + static_cast<size_t>(pair) * N + n) =
          o;
    }
  }
}

template <bool GATEUP>
void products(int variant, dim3 grid, cudaStream_t s, const float* a,
              const float* w, const float* wts, const int32_t* order,
              const int32_t* offsets, const int32_t* tile_e,
              const int32_t* tile_r, const int32_t* meta, int k, int K,
              int N, float* out) {
  if (variant == 0)
    moe_skinny_kernel<GATEUP><<<grid, SK_WARPS * 32, 0, s>>>(
        a, w, wts, order, offsets, tile_e, tile_r, meta, k, K, N, out);
  else if (variant == 1)
    moe_tiled_kernel<32, GATEUP><<<grid, TL_THREADS, 0, s>>>(
        a, w, wts, order, offsets, tile_e, tile_r, meta, k, K, N, out);
  else
    moe_tiled_kernel<64, GATEUP><<<grid, TL_THREADS, 0, s>>>(
        a, w, wts, order, offsets, tile_e, tile_r, meta, k, K, N, out);
}

}  // namespace

extern "C" {

// x [n, d], ids and wts [n * k] (token-major), wi [E, d, 2, ff],
// wo [E, ff, d], all contiguous; scratch int32 [P + E + 1 + 2 * max_tiles
// + 2]: order, offsets, tile experts, tile rows, meta; h [P, ff] and
// y [P, d] float32.  variant 0 (skinny, 8 rows), 1 (tiled, 32), 2 (tiled,
// 64); d and ff multiples of 64; E <= 256.
int moe_experts(const float* x, const int64_t* ids, const float* wts,
                const float* wi, const float* wo, int n, int k, int d,
                int ff, int E, int variant, int max_tiles, int32_t* scratch,
                float* h, float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = n * k;
  int32_t* order = scratch;
  int32_t* offsets = order + P;
  int32_t* tile_e = offsets + E + 1;
  int32_t* tile_r = tile_e + max_tiles;
  int32_t* meta = tile_r + max_tiles;
  const int bm = variant == 0 ? SK_ROWS : variant == 1 ? 32 : 64;
  moe_sort_kernel<<<1, SORT_THREADS, 0, s>>>(ids, P, E, bm, order, offsets,
                                             tile_e, tile_r, meta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cols = variant == 0 ? SK_COLS : TL_BN;
  products<true>(variant, dim3(max_tiles, ff / cols), s, x, wi, wts, order,
                 offsets, tile_e, tile_r, meta, k, d, ff, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  products<false>(variant, dim3(max_tiles, d / cols), s, h, wo, wts, order,
                  offsets, tile_e, tile_r, meta, k, ff, d, y);
  return static_cast<int>(cudaGetLastError());
}

const char* moe_experts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
