// Fused dequantize + scatter of decoded KV tokens into paged KV memory
// (the paper's Sparse_frame_KV_transfer), for every layer of a fetched
// chunk's layer group in one launch.
//
// Replaces: src/repro/kernels/kv_restore/kv_restore.py::kv_restore_pallas
// (the TPU kernel; one grid step per token of one layer, slots as scalar
// prefetch).
//
//   pages[layers[g], slots[i], h, d] = ((float(q[g, i, h, d]) - 128)
//                                       * scales[g, h]) cast to the page
//                                       dtype,
//   for every layer g < G of the group and token row i < n, skipped for a
//   row whose slot is negative (a dropped token) or not below R, the rows
//   of one layer.  pages is one kind's whole page tensor viewed as
//   [L, R, H, D]; the slots are shared by every layer of the group.  The
//   single-layer op is the case G = 1 (L = 1, layers = {0}).
//
// Bound on an H100: bytes.  Per launch it reads G*n*H*D uint8 and writes
// G*n*H*D page elements, with one multiply per element; one 16-token
// chunk of lwm-7b's 3-layer group (H = 32, D = 128) is 196 KB in and
// 786 KB out of fp32, about 0.29 us of HBM time.  So the launch sets its
// time, and the design's point is to launch once per fetched chunk rather
// than once per layer and frame (6 launches for that chunk before).
//
// Design: one block per (token row, layer), G*n blocks (48 for that
// chunk).  Each thread loads 16 uint8 at once (one 128-bit load),
// dequantizes them in fp32 and stores them as four 128-bit stores (fp32
// pages) into the row that the slot names in its layer.  At this size a
// launch is latency, not bandwidth: so the slot, the tokens and the
// layer's scales (read through the read-only cache, with no shared
// memory and no barrier) are all loaded before any is waited for, one
// memory round trip instead of three in a row.  The layer ids travel by
// value in the launch's parameters, so no device array has to be
// uploaded for them; the host checks them against L.  A dropped row
// stores nothing: the TPU
// kernel instead clamps a dropped slot to 0 and rewrites row 0 with its
// old value, which is harmless on the TPU's sequential grid but on a GPU
// would race with a real token whose slot is 0.  Rows or pointers that
// are not 16-byte aligned take a scalar loop instead.
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
constexpr int kMaxLayers = 64;  // layer ids one launch carries by value
constexpr float kQOff = 128.0f;

struct LayerIds {
  int32_t id[kMaxLayers];
};

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
                                  const LayerIds layers, int n, int H, int D,
                                  int64_t R, int vec) {
  const int row = blockIdx.x;
  const int g = blockIdx.y;
  const int hd = H * D;
  const uint8_t* src = q + (static_cast<int64_t>(g) * n + row) * hd;
  const float* sc = scales + static_cast<int64_t>(g) * H;
  // the slot, the tokens and the scales are loaded before any of them is
  // waited for; the slot is checked only before the stores
  const int64_t slot = slots[row];
  T* dst = pages + (static_cast<int64_t>(layers.id[g]) * R + slot) * hd;
  const bool keep = slot >= 0 && slot < R;  // else a dropped token
  if (vec) {
    // hd % 16 == 0 and both rows 16-byte aligned (checked by the launcher)
    for (int e0 = threadIdx.x * 16; e0 < hd; e0 += blockDim.x * 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + e0);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = (static_cast<float>(b[j]) - kQOff) * __ldg(sc + (e0 + j) / D);
      if (keep) store16(dst + e0, v);
    }
  } else {
    for (int e = threadIdx.x; e < hd; e += blockDim.x) {
      const float v = (static_cast<float>(src[e]) - kQOff) * __ldg(sc + e / D);
      if (keep) store_vals(dst + e, &v, 1);
    }
  }
}

// layer_ids: G host ints, each below L (checked by the caller).
template <typename T>
int launch(T* pages, const uint8_t* q, const float* scales,
           const int32_t* slots, const int32_t* layer_ids, int G, int n,
           int H, int D, int64_t R, int device, cudaStream_t stream) {
  if (G > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0 || G <= 0) return 0;
  LayerIds layers;
  for (int g = 0; g < G; ++g) layers.id[g] = layer_ids[g];
  const int hd = H * D;
  const int vec = (hd % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(pages) % 16 == 0) &&
                  ((static_cast<int64_t>(hd) * sizeof(T)) % 16 == 0);
  const int per_thread = vec ? 16 : 1;
  int threads = (hd + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  kv_restore_kernel<T><<<dim3(n, G), threads, 0, stream>>>(
      pages, q, scales, slots, layers, n, H, D, R, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int kv_restore_f32(void* pages, const void* q, const void* scales,
                   const void* slots, const int32_t* layer_ids, int G, int n,
                   int H, int D, int64_t R, int device, void* stream) {
  return launch(static_cast<float*>(pages), static_cast<const uint8_t*>(q),
                static_cast<const float*>(scales),
                static_cast<const int32_t*>(slots), layer_ids, G, n, H, D, R,
                device, static_cast<cudaStream_t>(stream));
}

int kv_restore_bf16(void* pages, const void* q, const void* scales,
                    const void* slots, const int32_t* layer_ids, int G,
                    int n, int H, int D, int64_t R, int device,
                    void* stream) {
  return launch(static_cast<__nv_bfloat16*>(pages),
                static_cast<const uint8_t*>(q),
                static_cast<const float*>(scales),
                static_cast<const int32_t*>(slots), layer_ids, G, n, H, D, R,
                device, static_cast<cudaStream_t>(stream));
}

int kv_restore_f16(void* pages, const void* q, const void* scales,
                   const void* slots, const int32_t* layer_ids, int G, int n,
                   int H, int D, int64_t R, int device, void* stream) {
  return launch(static_cast<__half*>(pages), static_cast<const uint8_t*>(q),
                static_cast<const float*>(scales),
                static_cast<const int32_t*>(slots), layer_ids, G, n, H, D, R,
                device, static_cast<cudaStream_t>(stream));
}

const char* kv_restore_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
