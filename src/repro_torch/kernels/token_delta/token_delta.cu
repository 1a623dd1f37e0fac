// Token-delta (inter-frame) transform of the KV codec's planes: the
// TEMPORAL residual of each frame against the one before it, zigzagged, and
// its one-frame inverse.
//
// Replaces: src/repro/kernels/token_delta/token_delta.py
//   ::token_delta_encode_pallas        (a grid of (8, 128) tiles per frame,
//                                       the reference tile fetched by a
//                                       second BlockSpec at frame f - 1)
//   ::token_delta_decode_frame_pallas  ((8, 128) tiles of one frame).
//
//   encode:  out[f, y, x] = zigzag((video[f, y, x] - video[f - 1, y, x])
//                                  mod 256), with frame -1 taken as 0;
//            zigzag(r) = r < 128 ? 2r : 2(256 - r) - 1 on a byte r.
//   decode:  out[y, x] = (prev[y, x] + unzigzag(zres[y, x])) mod 256;
//            unzigzag(z) = z even ? z / 2 : 256 - (z + 1) / 2.
//
// Bound on an H100: bytes.  Encode must read each of the F*H*W input bytes
// once and write each output byte once, 2*F*H*W bytes (the reference frame
// is a re-read of bytes already read, which L2 absorbs); decode reads two
// planes and writes one, 3*H*W bytes.  Both at 3.35 TB/s, with a handful of
// integer operations per byte, far below the ALU rate.  A 240p plane
// (240 x 432 = 103,680 bytes) moves in well under a microsecond of HBM
// time, so at the codec's plane sizes the launch sets the time; the bound
// is approached only by a stack of frames such as 64 x 1080 x 1920.
//
// Design: no tiling to carry over from the TPU.  The bytes are one flat
// array; each thread takes 16 consecutive bytes with one 128-bit load (and
// one 128-bit load of the reference frame), works on them as four 32-bit
// words with byte-wise SIMD arithmetic (__vsub4 / __vadd4 wrap mod 256; the
// zigzag is a shift, a mask and a sign mask per byte), and stores 16 bytes
// at once.  Neighbouring threads touch neighbouring 16-byte words, so every
// warp moves 512 contiguous bytes per array.  The vector path needs both
// arrays 16-byte aligned; the reference load is a vector only when it
// lies wholly in frame f - 1 and H*W is a multiple of 16 (else it is read
// byte by byte, as for the vector that straddles the end of frame 0, whose
// first bytes see the zero reference).  The last partial vector (n not a
// multiple of 16) and unaligned arrays take a scalar path.
//
// C interface (ctypes): each launcher returns a cudaError_t as int, 0 on
// success; the launch goes to the caller's stream and is not synchronised.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // bytes per thread: one uint4

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

__device__ __forceinline__ uint8_t unzigzag1(uint8_t z) {
  return static_cast<uint8_t>(unzigzag4(z));
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

__global__ void decode_frame_kernel(const uint8_t* __restrict__ prev,
                                    const uint8_t* __restrict__ zres,
                                    uint8_t* __restrict__ out, int64_t n,
                                    int aligned) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (i >= n) return;
  if (aligned && i + kVec <= n) {
    const uint4 p = *reinterpret_cast<const uint4*>(prev + i);
    const uint4 z = *reinterpret_cast<const uint4*>(zres + i);
    uint4 o;
    o.x = __vadd4(p.x, unzigzag4(z.x));
    o.y = __vadd4(p.y, unzigzag4(z.y));
    o.z = __vadd4(p.z, unzigzag4(z.z));
    o.w = __vadd4(p.w, unzigzag4(z.w));
    *reinterpret_cast<uint4*>(out + i) = o;
  } else {
    const int64_t end = i + kVec < n ? i + kVec : n;
    for (int64_t e = i; e < end; ++e)
      out[e] = static_cast<uint8_t>(prev[e] + unzigzag1(zres[e]));
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % kVec == 0;
}

// blocks for n bytes at kVec bytes a thread; 0 if the grid would not fit
unsigned int grid_for(int64_t n) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kVec;
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
  const unsigned int grid = grid_for(n);
  if (hw <= 0 || n % hw != 0 || grid == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = aligned16(video) && aligned16(out);
  encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(video), static_cast<uint8_t*>(out), n, hw,
      aligned);
  return static_cast<int>(cudaGetLastError());
}

int token_delta_decode_frame(const void* prev, const void* zres, void* out,
                             int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const unsigned int grid = grid_for(n);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int aligned = aligned16(prev) && aligned16(zres) && aligned16(out);
  decode_frame_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(zres),
      static_cast<uint8_t*>(out), n, aligned);
  return static_cast<int>(cudaGetLastError());
}

const char* token_delta_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
