// Fused dequantize + scatter of one decoded frame's KV tokens into paged
// KV memory (the paper's Sparse_frame_KV_transfer, frame-wise restore).
//
// Replaces: src/repro/kernels/kv_restore/kv_restore.py::kv_restore_pallas
// (the TPU kernel; one grid step per token, slots as scalar prefetch).
//
//   pages[slots[i], h, d] = ((float(q[i, h, d]) - 128) * scales[h])
//                           cast to the page dtype,
//   skipped for a row whose slot is negative (a dropped token) or not
//   below R, the number of page rows.
//
// Bound on an H100: bytes.  Per launch it reads n*H*D uint8 and writes
// n*H*D page elements, with one multiply per element; at lwm-7b
// (H = 32, D = 128, n = 8 tokens per 240p frame) that is 32 KB in and
// 128 KB out, so it is over in well under a microsecond of HBM time and
// the launch overhead sets its time.
//
// Design: one block per token row.  Each thread loads 16 uint8 at once
// (one 128-bit load), dequantizes them in fp32 and stores them as four
// 128-bit stores (fp32 pages) into the row that the slot names.  The
// per-head scales sit in shared memory.  A dropped row is skipped: the
// TPU kernel instead clamps a dropped slot to 0 and rewrites row 0 with
// its old value, which is harmless on the TPU's sequential grid but on a
// GPU would race with a real token whose slot is 0.  Rows or pointers
// that are not 16-byte aligned take a scalar loop instead.
//
// C interface (ctypes): each kv_restore_<dtype> returns a cudaError_t as
// int, 0 on success; the launch goes to the caller's stream and is not
// synchronised.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kQOff = 128.0f;

__device__ __forceinline__ void store_vals(float* dst, const float* v,
                                           int cnt) {
  for (int j = 0; j < cnt; ++j) dst[j] = v[j];
}
__device__ __forceinline__ void store_vals(__nv_bfloat16* dst,
                                           const float* v, int cnt) {
  for (int j = 0; j < cnt; ++j) dst[j] = __float2bfloat16(v[j]);
}
__device__ __forceinline__ void store_vals(__half* dst, const float* v,
                                           int cnt) {
  for (int j = 0; j < cnt; ++j) dst[j] = __float2half(v[j]);
}

// 16 values with 128-bit stores where the destination allows it.
__device__ __forceinline__ void store16(float* dst, const float* v) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    d4[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}
template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* v) {
  store_vals(dst, v, 16);
}

template <typename T>
__global__ void kv_restore_kernel(T* __restrict__ pages,
                                  const uint8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  const int32_t* __restrict__ slots,
                                  int H, int D, int64_t R, int vec) {
  extern __shared__ float s_scales[];
  const int row = blockIdx.x;
  const int64_t slot = slots[row];
  if (slot < 0 || slot >= R) return;  // dropped token: the row is untouched
  for (int h = threadIdx.x; h < H; h += blockDim.x) s_scales[h] = scales[h];
  __syncthreads();

  const int hd = H * D;
  const uint8_t* src = q + static_cast<int64_t>(row) * hd;
  T* dst = pages + slot * hd;
  if (vec) {
    // hd % 16 == 0 and both rows 16-byte aligned (checked by the launcher)
    for (int e0 = threadIdx.x * 16; e0 < hd; e0 += blockDim.x * 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + e0);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = (static_cast<float>(b[j]) - kQOff) * s_scales[(e0 + j) / D];
      store16(dst + e0, v);
    }
  } else {
    for (int e = threadIdx.x; e < hd; e += blockDim.x) {
      const float v = (static_cast<float>(src[e]) - kQOff) * s_scales[e / D];
      store_vals(dst + e, &v, 1);
    }
  }
}

template <typename T>
int launch(T* pages, const uint8_t* q, const float* scales,
           const int32_t* slots, int n, int H, int D, int64_t R, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const int hd = H * D;
  const int vec = (hd % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(pages) % 16 == 0) &&
                  ((static_cast<int64_t>(hd) * sizeof(T)) % 16 == 0);
  const int per_thread = vec ? 16 : 1;
  int threads = (hd + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  kv_restore_kernel<T><<<n, threads, H * sizeof(float), stream>>>(
      pages, q, scales, slots, H, D, R, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int kv_restore_f32(void* pages, const void* q, const void* scales,
                   const void* slots, int n, int H, int D, int64_t R,
                   int device, void* stream) {
  return launch(static_cast<float*>(pages), static_cast<const uint8_t*>(q),
                static_cast<const float*>(scales),
                static_cast<const int32_t*>(slots), n, H, D, R, device,
                static_cast<cudaStream_t>(stream));
}

int kv_restore_bf16(void* pages, const void* q, const void* scales,
                    const void* slots, int n, int H, int D, int64_t R,
                    int device, void* stream) {
  return launch(static_cast<__nv_bfloat16*>(pages),
                static_cast<const uint8_t*>(q),
                static_cast<const float*>(scales),
                static_cast<const int32_t*>(slots), n, H, D, R, device,
                static_cast<cudaStream_t>(stream));
}

int kv_restore_f16(void* pages, const void* q, const void* scales,
                   const void* slots, int n, int H, int D, int64_t R,
                   int device, void* stream) {
  return launch(static_cast<__half*>(pages), static_cast<const uint8_t*>(q),
                static_cast<const float*>(scales),
                static_cast<const int32_t*>(slots), n, H, D, R, device,
                static_cast<cudaStream_t>(stream));
}

const char* kv_restore_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
