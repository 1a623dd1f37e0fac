// Token-delta (inter-frame) transform of the KV codec's planes: the
// TEMPORAL residual of each frame against the one before it, zigzagged, and
// its inverse over a whole stack of frames.
//
// Replaces: src/repro/kernels/token_delta/token_delta.py
//   ::token_delta_encode_pallas        (:39; a grid of (8, 128) tiles per
//                                       frame, the reference tile fetched
//                                       by a second BlockSpec at frame
//                                       f - 1)
//   ::token_delta_decode_frame_pallas  (:66; (8, 128) tiles of one frame).
//
//   encode:  out[f, y, x] = zigzag((video[f, y, x] - video[f - 1, y, x])
//                                  mod 256), with frame -1 taken as 0;
//            zigzag(r) = r < 128 ? 2r : 2(256 - r) - 1 on a byte r.
//   decode:  out[f, y, x] = (prev[y, x] + sum_{g <= f} unzigzag(zres[g, y,
//                            x])) mod 256;
//            unzigzag(z) = z even ? z / 2 : 256 - (z + 1) / 2.
//   The TPU kernel decodes one frame, out = prev + unzigzag(zres); chained
//   frame by frame that is the decode above, and the one-frame op here is
//   its case F = 1.
//
// Bound on an H100: bytes.  Encode must read each of the F*H*W input bytes
// once and write each output byte once, 2*F*H*W bytes (the reference frame
// is a re-read of bytes already read, which L2 absorbs).  Decode reads the
// reference frame once, each residual byte once and writes each output
// byte once, (2F + 1)*H*W bytes; decoded one frame per launch, each frame
// would also re-read the frame the launch before wrote, 3*F*H*W.  All at
// 3.35 TB/s, with a handful of integer operations per byte, far below the
// ALU rate.  A 240p plane (128 x 416 = 53,248 bytes) moves in 16 ns of HBM
// time, so a launch per frame is all launch; a stack of 40 such frames is
// 4.3 MB, 1.29 us, and a 64 x 1080 x 1920 stack 80 us.
//
// Encode design: no tiling to carry over from the TPU.  The bytes are one
// flat array; each thread takes 16 consecutive bytes with one 128-bit load
// (and one 128-bit load of the reference frame), works on them as four
// 32-bit words with byte-wise SIMD arithmetic (__vsub4 / __vadd4 wrap mod
// 256; the zigzag is a shift, a mask and a sign mask per byte), and stores
// 16 bytes at once.  Neighbouring threads touch neighbouring 16-byte
// words, so every warp moves 512 contiguous bytes per array.  The vector
// path needs both arrays 16-byte aligned; the reference load is a vector
// only when it lies wholly in frame f - 1 and H*W is a multiple of 16
// (else it is read byte by byte, as for the vector that straddles the end
// of frame 0, whose first bytes see the zero reference).  The last
// partial vector (n not a multiple of 16) and unaligned arrays take a
// scalar path.
//
// Decode design: one launch per stack, as a segmented scan over the frame
// axis (addition mod 256 is associative, so the sums may be taken in any
// order and the result is bit-equal to the chained one-frame decode).
// Each thread owns a column: 16 contiguous bytes of the frame, through the
// frames of its segment.  The S (a power of two, at most 16) lanes of a
// group in a warp are the S segments of one column, each a contiguous run
// of at most kRunMax frames; a warp holds 32 / S columns, a block of 256
// threads 256 / S.  The launcher takes the fewest segments that still give
// each SM two blocks (so the widest contiguous tiles), at most F: the
// path's [40, 128, 416] stack runs 16 segments of 3 frames over 208 blocks
// for 132 SMs (a launch per frame had 13); a 64 x 1080 x 1920 stack one
// segment, a column per thread through 8 rounds of 8 frames, 507 blocks.
//   pass 1: each thread issues the loads of its run's residual vectors
//           (up to kRunMax 128-bit loads in flight), unzigzags them into
//           registers and sums them with __vadd4.
//   scan:   an inclusive scan of the run sums across the group's lanes by
//           __shfl_up_sync, log2(S) steps; no shared memory and no barrier
//           (summing the segments before its own from shared memory, S
//           reads per thread after a barrier, was the slower design).
//   pass 2: each thread starts from the running frame plus the segments
//           before its own, walks its run and stores each frame with one
//           128-bit store.  The running frame (the reference frame, read
//           once per column, then each round's last frame) grows by the
//           group's total.
// A stack of more than S*kRunMax frames runs in rounds, the group carrying
// the running frame in registers.  Segment bounds are multiplications
// only: a 64-bit division per thread would delay every load behind it.
// The run length picks one of four kernels (1, 2, 4 or 8 frames in
// registers), so that a short run keeps few registers.  The vector path
// needs all three arrays 16-byte aligned and H*W a multiple of 16 (so
// every frame starts aligned); else every vector is gathered and stored
// byte by byte, with the bytes past the frame's end left out.
//
// C interface (ctypes): each launcher returns a cudaError_t as int, 0 on
// success; the launch goes to the caller's stream and is not synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;     // bytes per thread and frame: one uint4
// decode: at most this many segments of the frame axis per column, and
// frames held per thread and round; fewer segments while the grid still
// gives each SM kBlocksPerSm blocks
constexpr int kSegMax = 16;
constexpr int kRunMax = 8;
constexpr int kBlocksPerSm = 2;

// zigzag of four bytes at once: each byte r read as a signed delta s gives
// (s << 1) ^ (s >> 7), which is r < 128 ? 2r : 2(256 - r) - 1.
__device__ __forceinline__ uint32_t zigzag4(uint32_t r) {
  const uint32_t sign = (r >> 7) & 0x01010101u;
  return ((r << 1) & 0xFEFEFEFEu) ^ (sign * 0xFFu);
}

// inverse: (z >> 1) ^ -(z & 1) per byte, which is z even ? z / 2
// : 256 - (z + 1) / 2.
__device__ __forceinline__ uint32_t unzigzag4(uint32_t z) {
  const uint32_t odd = z & 0x01010101u;
  return ((z >> 1) & 0x7F7F7F7Fu) ^ (odd * 0xFFu);
}

__device__ __forceinline__ uint8_t zigzag1(uint8_t r) {
  return static_cast<uint8_t>(zigzag4(r));
}

__device__ __forceinline__ uint4 unzigzag16(uint4 z) {
  return make_uint4(unzigzag4(z.x), unzigzag4(z.y), unzigzag4(z.z),
                    unzigzag4(z.w));
}

// byte-wise a + b mod 256 of 16 bytes
__device__ __forceinline__ uint4 add16(uint4 a, uint4 b) {
  return make_uint4(__vadd4(a.x, b.x), __vadd4(a.y, b.y), __vadd4(a.z, b.z),
                    __vadd4(a.w, b.w));
}

// 16 bytes from p, of which only the first `rem` exist when not kAligned
// (the rest read as 0)
template <bool kAligned>
__device__ __forceinline__ uint4 load16(const uint8_t* p, int64_t rem) {
  if (kAligned) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (j < rem) w[j >> 2] |= static_cast<uint32_t>(p[j]) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kAligned>
__device__ __forceinline__ void store16(uint8_t* p, uint4 v, int64_t rem) {
  if (kAligned) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (j < rem) p[j] = static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3)));
}

__global__ void encode_kernel(const uint8_t* __restrict__ video,
                              uint8_t* __restrict__ out, int64_t n,
                              int64_t hw, int aligned) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (i >= n) return;
  if (aligned && i + kVec <= n) {
    const uint4 cur = *reinterpret_cast<const uint4*>(video + i);
    uint4 ref;
    if (i >= hw && hw % kVec == 0) {
      ref = *reinterpret_cast<const uint4*>(video + i - hw);
    } else {
      // frame 0, the vector that straddles its end, or a frame size that
      // keeps the reference unaligned
      uint8_t* r = reinterpret_cast<uint8_t*>(&ref);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        r[j] = i + j >= hw ? video[i + j - hw] : 0;
    }
    uint4 z;
    z.x = zigzag4(__vsub4(cur.x, ref.x));
    z.y = zigzag4(__vsub4(cur.y, ref.y));
    z.z = zigzag4(__vsub4(cur.z, ref.z));
    z.w = zigzag4(__vsub4(cur.w, ref.w));
    *reinterpret_cast<uint4*>(out + i) = z;
  } else {
    const int64_t end = i + kVec < n ? i + kVec : n;
    for (int64_t e = i; e < end; ++e) {
      const uint8_t r = e >= hw ? video[e - hw] : 0;
      out[e] = zigzag1(static_cast<uint8_t>(video[e] - r));
    }
  }
}

// the 16 bytes of lane (own lane - d) of this lane's group of `width`
// lanes, or its own where that lane lies before the group
__device__ __forceinline__ uint4 shfl_up16(uint4 v, int d, int width) {
  return make_uint4(__shfl_up_sync(0xFFFFFFFFu, v.x, d, width),
                    __shfl_up_sync(0xFFFFFFFFu, v.y, d, width),
                    __shfl_up_sync(0xFFFFFFFFu, v.z, d, width),
                    __shfl_up_sync(0xFFFFFFFFu, v.w, d, width));
}

// the 16 bytes of lane `src` of this lane's group of `width` lanes
__device__ __forceinline__ uint4 shfl16(uint4 v, int src, int width) {
  return make_uint4(__shfl_sync(0xFFFFFFFFu, v.x, src, width),
                    __shfl_sync(0xFFFFFFFFu, v.y, src, width),
                    __shfl_sync(0xFFFFFFFFu, v.z, src, width),
                    __shfl_sync(0xFFFFFFFFu, v.w, src, width));
}

// byte-wise a - b mod 256 of 16 bytes
__device__ __forceinline__ uint4 sub16(uint4 a, uint4 b) {
  return make_uint4(__vsub4(a.x, b.x), __vsub4(a.y, b.y), __vsub4(a.z, b.z),
                    __vsub4(a.w, b.w));
}

// prev [n], zres [F, n] -> out [F, n].  The S = 2^log_s lanes of a group
// in a warp are the segments of one column (16 bytes of every frame); a
// warp holds 32 / S columns.  Segment s of round r runs `seg` frames from
// frame (r * S + s) * seg, clipped to F.
template <bool kAligned, int kRun>
__global__ void __launch_bounds__(kThreads)
decode_frames_kernel(const uint8_t* __restrict__ prev,
                     const uint8_t* __restrict__ zres,
                     uint8_t* __restrict__ out, int64_t F, int64_t n,
                     int log_s, int seg, int64_t rounds) {
  const int S = 1 << log_s, s = threadIdx.x & (S - 1);
  // this lane's column: its 16 bytes of every frame, and how many exist
  const int64_t col = static_cast<int64_t>(blockIdx.x) * (kThreads >> log_s)
                      + (threadIdx.x >> log_s);
  const int64_t i = col * kVec, rem = n - i;
  const bool live = rem > 0;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // the running frame: the reference frame, then each round's last frame
  // (the group's lanes read the same 16 bytes: one transaction)
  uint4 carry = live ? load16<kAligned>(prev + i, rem) : zero;
  for (int64_t r = 0; r < rounds; ++r) {
    const int64_t a = (r * S + s) * seg;
    const int64_t len = a < F ? (F - a < seg ? F - a : seg) : 0;
    // pass 1: every load of the run first, then the run's sum
    uint4 z[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      z[j] = j < len && live
                 ? load16<kAligned>(zres + (a + j) * n + i, rem)
                 : zero;
    uint4 acc = zero;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      z[j] = unzigzag16(z[j]);
      acc = add16(acc, z[j]);
    }
    // the sums of the segments up to this one: a scan across the group's
    // lanes by shuffles, log2(S) steps, no shared memory and no barrier
    uint4 inc = acc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d < S) {
        const uint4 up = shfl_up16(inc, d, S);
        if (s >= d) inc = add16(inc, up);
      }
    }
    // pass 2: from the running frame plus the segments before this one,
    // the run, one store per frame
    uint4 x = add16(carry, sub16(inc, acc));
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      if (j < len) {
        x = add16(x, z[j]);
        if (live) store16<kAligned>(out + (a + j) * n + i, x, rem);
      }
    }
    carry = add16(carry, shfl16(inc, S - 1, S));
  }
}

template <int kRun>
void launch_decode(bool aligned, unsigned int grid, cudaStream_t st,
                   const uint8_t* p, const uint8_t* z, uint8_t* o, int64_t F,
                   int64_t n, int log_s, int seg, int64_t rounds) {
  if (aligned)
    decode_frames_kernel<true, kRun><<<grid, kThreads, 0, st>>>(
        p, z, o, F, n, log_s, seg, rounds);
  else
    decode_frames_kernel<false, kRun><<<grid, kThreads, 0, st>>>(
        p, z, o, F, n, log_s, seg, rounds);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVec == 0;
}

// blocks for n bytes at kVec bytes a thread; 0 if the grid would not fit
unsigned int grid_for(int64_t n, int64_t threads) {
  const int64_t per_block = threads * kVec;
  const int64_t blocks = (n + per_block - 1) / per_block;
  return blocks > 0x7fffffff ? 0u : static_cast<unsigned int>(blocks);
}

}  // namespace

extern "C" {

int token_delta_encode(const void* video, void* out, int64_t n, int64_t hw,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const unsigned int grid = grid_for(n, kThreads);
  if (hw <= 0 || n % hw != 0 || grid == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = aligned16(video) && aligned16(out);
  encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(video), static_cast<uint8_t*>(out), n, hw,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

// prev [n], zres [F, n] -> out [F, n]: frame f is prev plus the
// unzigzagged residuals of frames 0..f, mod 256
int token_delta_decode_frames(const void* prev, const void* zres, void* out,
                              int64_t F, int64_t n, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (F < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (F == 0 || n == 0) return 0;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the fewest segments (the widest contiguous tiles) that still give
  // every SM kBlocksPerSm blocks, at most kSegMax and F
  int log_s = 0;
  while ((1 << log_s) < kSegMax && (1 << log_s) < F
         && grid_for(n, kThreads >> log_s)
                < static_cast<int64_t>(kBlocksPerSm) * sms)
    ++log_s;
  const int64_t S = int64_t{1} << log_s;
  const int64_t rounds = (F + S * kRunMax - 1) / (S * kRunMax);
  const int seg = static_cast<int>((F + rounds * S - 1) / (rounds * S));
  const unsigned int grid = grid_for(n, kThreads >> log_s);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = aligned16(prev) && aligned16(zres) && aligned16(out)
                       && n % kVec == 0;
  const auto* p = static_cast<const uint8_t*>(prev);
  const auto* z = static_cast<const uint8_t*>(zres);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // the fewest registers that hold a run
  if (seg <= 1)
    launch_decode<1>(aligned, grid, st, p, z, o, F, n, log_s, seg, rounds);
  else if (seg <= 2)
    launch_decode<2>(aligned, grid, st, p, z, o, F, n, log_s, seg, rounds);
  else if (seg <= 4)
    launch_decode<4>(aligned, grid, st, p, z, o, F, n, log_s, seg, rounds);
  else
    launch_decode<kRunMax>(aligned, grid, st, p, z, o, F, n, log_s, seg,
                           rounds);
  return static_cast<int>(cudaGetLastError());
}

const char* token_delta_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
