// Interleaved rANS decode of a fetched chunk's entropy streams on the card,
// every stream of the chunk in one launch.
//
// Replaces no TPU kernel: the JAX package decodes rANS on the host in numpy
// (src/repro/core/entropy.py::StreamDecoder.read), and so did the port.  On
// the port's main path this kernel takes the place of that host loop
// (src/repro_torch/core/entropy.py::StreamDecoder.read), the stage that
// NVDEC's entropy decoder runs on a GPU in the paper.
//
// A stream (core/entropy.py::encode) holds n byte symbols coded in `lanes`
// interleaved rANS states of 64 bits, a 12-bit frequency table and the
// 32-bit words that the states take back in as they shrink.  Round r
// decodes symbol r * lanes + l in lane l, for every lane (the padded lanes
// of the last round too):
//
//   slot = x & 4095;  sym = sym_of[slot];
//   x = freq[sym] * (x >> 12) + slot - cum[sym];
//   if (x < 2^31) x = (x << 32) | words[wpos + (refills of lanes below)];
//
// where the lanes that refill in a round take the stream's next words in
// ascending lane order.
//
// Bound on an H100: neither bytes nor operations.  A yi-9b chunk at 240p
// (1,024 tokens x 3 layers x 4 kv heads x 128) is about 1.1 MB of streams
// in and 1.58 MB of symbols out, under 1 us of HBM time; it is a few
// integer operations a symbol.  What sets the time is the chain of rounds
// of the longest stream (up to 2,052 rounds of 256 lanes there): each
// round needs the previous round's states and word position.  So the
// design's whole aim is a short round:
//   - one block per stream, one thread per lane (lanes <= 1024): the
//     chunk's six streams (three channels x I/P) decode side by side on six
//     SMs, and an empty stream gets no block;
//   - one 4,096-entry table in shared memory packs sym, freq and
//     slot - cum into 32 bits, so a round's lookup is one shared load;
//   - a refilling lane's word offset is its rank in its warp
//     (__ballot_sync, __popc) plus its warp's base, the exclusive prefix of
//     the warps' totals: one byte a warp in shared memory, read after the
//     round's only __syncthreads in two 16-byte loads and summed with
//     __dp4a; the totals are double-buffered, so that one barrier a round
//     is enough;
//   - refill words come from a ring of 8 x 1,024 words in shared memory
//     that cp.async keeps filled ahead (one segment issued a round at most,
//     a segment waited for 5 rounds after its issue), so a refill never
//     waits on device memory;
//   - symbols are staged in shared memory, 16 rounds at a time in two
//     buffers, and written out in 16-byte stores.
//
// Input (one device buffer, filled by the host): per stream, a descriptor
// of 8 int64 (byte offsets of its freq table, states and words, its word
// count, n, lanes and the byte offset of its symbols in `out`), then the
// tables, states and words themselves, each at a 16-byte aligned offset.
// Output: per stream the words it read, as int64 at the front of `out`
// (the host checks them against the word counts), then the symbols.
//
// C interface (ctypes): rans_decode returns a cudaError_t as int, 0 on
// success; the launch goes to the caller's stream and is not synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProbBits = 12;
constexpr uint32_t kProbMask = (1u << kProbBits) - 1;
constexpr uint64_t kRansL = 1ull << 31;
constexpr int kSegWords = 1024;  // one ring segment; >= lanes, so a round
                                 // reads at most one segment's worth
constexpr int kSegs = 8;
constexpr int kRingWords = kSegWords * kSegs;
// cp.async groups (one a round) that may still be in flight when a round
// reads the ring: a segment is issued at least kSegs - 3 rounds before a
// round can need it (see the proof at the issue below)
constexpr int kPending = kSegs - 3;
constexpr int kStageRounds = 16;
constexpr int kMaxThreads = 1024;

struct Desc {
  int64_t freq_off, states_off, words_off, n_words, n, lanes, out_off, pad;
};

__host__ __device__ constexpr int smem_bytes(int threads) {
  return kRingWords * 4 + (1 << kProbBits) * 4 + 2 * kStageRounds * threads;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy ring segment `seg` of the stream's words into its slot; bytes past
// the stream's last word are zero-filled.
__device__ __forceinline__ void issue_segment(uint32_t* ring,
                                              const uint8_t* words,
                                              int64_t word_bytes, int seg) {
  constexpr int kPieces = kSegWords * 4 / 16;
  uint32_t* slot = ring + (seg % kSegs) * kSegWords;
  for (int p = threadIdx.x; p < kPieces; p += blockDim.x) {
    const int64_t at = static_cast<int64_t>(seg) * kSegWords * 4 + 16 * p;
    const int64_t left = word_bytes - at;
    const int bytes = left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
    cp_async16(slot + 4 * p, bytes ? words + at : words, bytes);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    rans_decode_kernel(const uint8_t* __restrict__ in,
                       uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  uint32_t* table = ring + kRingWords;  // sym | freq << 8 | (slot-cum) << 20
  uint8_t* stage = reinterpret_cast<uint8_t*>(table + (1 << kProbBits));
  __shared__ uint32_t s_freq[256];
  __shared__ uint32_t s_cum[256];
  // each warp's refills in a round, one byte a warp, double-buffered
  __shared__ __align__(16) uint8_t totals[2][kMaxThreads / 32];

  const Desc d = reinterpret_cast<const Desc*>(in)[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lanes = static_cast<int>(d.lanes);
  const int64_t n = d.n;
  const uint8_t* words = in + d.words_off;
  const int64_t word_bytes = 4 * d.n_words;
  const int nseg = static_cast<int>((d.n_words + kSegWords - 1) / kSegWords);

  // the ring's first segments load while the table is built
  int seg_hi = nseg < kSegs ? nseg : kSegs;
  for (int s = 0; s < seg_hi; ++s) issue_segment(ring, words, word_bytes, s);
  cp_async_commit();

  const uint16_t* freq = reinterpret_cast<const uint16_t*>(in + d.freq_off);
  for (int s = tid; s < 256; s += blockDim.x) s_freq[s] = freq[s];
  for (int i = tid; i < 2 * kMaxThreads / 32; i += blockDim.x)
    reinterpret_cast<uint8_t*>(totals)[i] = 0;  // warps past the block stay 0
  const bool active = tid < lanes;
  uint64_t x = active
      ? reinterpret_cast<const uint64_t*>(in + d.states_off)[tid] : kRansL;
  __syncthreads();
  if (warp == 0) {  // cum: each lane sums 8 symbols, then a warp scan
    uint32_t v[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = s_freq[lane * 8 + j];
      sum += v[j];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    uint32_t c = incl - sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s_cum[lane * 8 + j] = c;
      c += v[j];
    }
  }
  __syncthreads();
  // the host checked that the table sums to 4096 with every freq < 4096
  for (int s = warp; s < 256; s += blockDim.x >> 5) {
    const uint32_t f = s_freq[s], c = s_cum[s];
    for (uint32_t k = lane; k < f; k += 32)
      table[c + k] = static_cast<uint32_t>(s) | f << 8 | k << 20;
  }
  cp_async_wait<0>();
  __syncthreads();

  const uint32_t rounds = static_cast<uint32_t>((n + lanes - 1) / lanes);
  const unsigned below = (1u << lane) - 1u;
  // byte selectors of the warps below this one, four warps a word: a
  // warp's base is then eight __dp4a over the 32 totals
  uint32_t sel[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = warp - 4 * j;
    sel[j] = k >= 4 ? 0x01010101u
                    : (k <= 0 ? 0u : 0x01010101u & ((1u << (8 * k)) - 1u));
  }
  uint8_t* dst = out + d.out_off;
  uint32_t wpos = 0, prev_start = 0;
  for (uint32_t r = 0; r < rounds; ++r) {
    // Issue the next segment once the slot it takes held only words below
    // the previous round's start (so no lane still reads it).  A round
    // reads below wpos + lanes <= its predecessor's start + 2 * kSegWords,
    // i.e. at most two segments past the predecessor's; the start moves
    // at most one segment a round, so that segment was issued at least
    // kSegs - 3 rounds ago, and wait_group kPending has completed it.
    if (seg_hi < nseg &&
        seg_hi < static_cast<int>(prev_start / kSegWords) + kSegs) {
      issue_segment(ring, words, word_bytes, seg_hi);
      ++seg_hi;
    }
    cp_async_commit();  // every round, so the count of groups is uniform

    const uint32_t e = table[static_cast<uint32_t>(x) & kProbMask];
    x = static_cast<uint64_t>((e >> 8) & 0xfffu) * (x >> kProbBits) +
        (e >> 20);
    const bool need = active && x < kRansL;
    const int sr = static_cast<int>(r & (kStageRounds - 1));
    uint8_t* buf = stage + ((r / kStageRounds) & 1) * kStageRounds *
                               blockDim.x;
    if (active) buf[sr * lanes + tid] = static_cast<uint8_t>(e);
    const unsigned m = __ballot_sync(0xffffffffu, need);
    if (lane == 0) totals[r & 1][warp] = static_cast<uint8_t>(__popc(m));
    cp_async_wait<kPending>();
    __syncthreads();

    const uint4 t03 = reinterpret_cast<const uint4*>(totals[r & 1])[0];
    const uint4 t47 = reinterpret_cast<const uint4*>(totals[r & 1])[1];
    const uint32_t t[8] = {t03.x, t03.y, t03.z, t03.w,
                           t47.x, t47.y, t47.z, t47.w};
    uint32_t b[8], a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      b[j] = __dp4a(t[j], sel[j], 0u);
      a[j] = __dp4a(t[j], 0x01010101u, 0u);
    }
    const uint32_t base = ((b[0] + b[1]) + (b[2] + b[3])) +
                          ((b[4] + b[5]) + (b[6] + b[7]));
    const uint32_t total = ((a[0] + a[1]) + (a[2] + a[3])) +
                           ((a[4] + a[5]) + (a[6] + a[7]));
    if (need)
      x = (x << 32) |
          ring[(wpos + base + __popc(m & below)) & (kRingWords - 1)];
    prev_start = wpos;
    wpos += total;

    if (sr == kStageRounds - 1 || r == rounds - 1) {
      // this buffer's rounds are staged (before the barrier above); the
      // next writes to it come 16 rounds and barriers later
      const int64_t g0 = static_cast<int64_t>(r - sr) * lanes;
      int64_t len = static_cast<int64_t>(sr + 1) * lanes;
      if (len > n - g0) len = n - g0;
      for (int64_t p = 16 * tid; p < len; p += 16 * blockDim.x) {
        if (p + 16 <= len) {
          *reinterpret_cast<uint4*>(dst + g0 + p) =
              *reinterpret_cast<const uint4*>(buf + p);
        } else {
          for (int64_t q = p; q < len; ++q) dst[g0 + q] = buf[q];
        }
      }
    }
  }
  if (tid == 0) reinterpret_cast<int64_t*>(out)[blockIdx.x] = wpos;
}

}  // namespace

extern "C" {

// in, out: device buffers laid out as above; threads: a multiple of 32 of
// at most 1024, at least every stream's lanes.
int rans_decode(const void* in, void* out, int n_streams, int threads,
                int device, void* stream) {
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_streams <= 0) return 0;
  const int smem = smem_bytes(threads);
  // set on every launch: the limit is the function's, for the process
  err = cudaFuncSetAttribute(rans_decode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rans_decode_kernel<<<n_streams, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* rans_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
