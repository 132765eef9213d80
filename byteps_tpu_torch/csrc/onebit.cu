// Onebit sign compression kernels for Hopper (sm_90a).
//
// They replace the three Pallas TPU kernels of
// byteps_tpu/ops/pallas_kernels.py: onebit_pack (_pack_kernel),
// onebit_unpack (_unpack_kernel, _expand_bits) and onebit_unpack_sum
// (_unpack_sum_kernel).  The wire layout is theirs: the flat chunk of
// `numel` floats, zero-padded to 32 * L (L = padded_lanes(numel), a
// multiple of 128), is a (32, L) matrix, and bit i of word j is the sign
// (x >= 0) of element i * L + j.  Padding elements are +0.0 and pack as 1
// bits; -0.0 packs as 1 and NaN as 0.
//
// Bounds (H100 SXM, 3.35 TB/s): every kernel is bound by device-memory
// bytes, at about one flop per byte.  pack reads 4 * numel bytes and
// writes numel / 8; unpack writes 4 * numel; unpack_sum reads
// R * numel / 8 and writes 4 * numel.  The design is the simplest one that
// keeps those streams coalesced: one thread per packed word j, looping
// over the 32 rows i, so a warp touches 32 consecutive floats (128 bytes)
// of row i at each step.  Indices at or past numel read as +0.0 and are
// never written, so the kernels take and produce the unpadded chunk and
// no padded copy exists in device memory.
//
// The L1 sum of pack (the scale) is reduced without float atomics: one
// fixed-order tree per block into per-block partials, then one block
// reduces the partials in a fixed order, so the scale is the same from
// run to run.  unpack_sum adds ranks in the order r = 0..R-1, as the
// reference's fori_loop does; since sign * scale is exact, its result is
// bit-identical to the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the Python wrapper sizes partials with it

__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, long long numel, int L,
            uint32_t* __restrict__ words, float* __restrict__ partials) {
  __shared__ float sh[kThreads];
  const int j = blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.0f;
  if (j < L) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const long long idx = (long long)i * L + j;
      const float v = idx < numel ? x[idx] : 0.0f;
      w |= (uint32_t)(v >= 0.0f) << i;
      acc += fabsf(v);
    }
    words[j] = w;
  }
  const float total = block_sum(acc, sh);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// out[0] = sum(|x|), out[1] = sum(|x|) / numel (IEEE division, as the
// reference's abs_sum / numel).
__global__ void __launch_bounds__(kThreads)
pack_finish_kernel(const float* __restrict__ partials, int nparts,
                   float numel_f, float* __restrict__ out) {
  __shared__ float sh[kThreads];
  float acc = 0.0f;
  for (int k = threadIdx.x; k < nparts; k += kThreads) acc += partials[k];
  const float total = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    out[0] = total;
    out[1] = total / numel_f;
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ words,
              const float* __restrict__ scale, int L, long long numel,
              float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= L) return;
  const uint32_t w = words[j];
  const float s = *scale;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long idx = (long long)i * L + j;
    if (idx < numel) out[idx] = ((w >> i) & 1u) ? s : -s;
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_sum_kernel(const uint32_t* __restrict__ words,
                  const float* __restrict__ scales, int R, int L,
                  long long numel, float* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= L) return;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int r = 0; r < R; ++r) {
    const uint32_t w = words[(long long)r * L + j];
    const float s = scales[r];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] += ((w >> i) & 1u) ? s : -s;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long idx = (long long)i * L + j;
    if (idx < numel) out[idx] = acc[i];
  }
}

inline int blocks_for(int L) { return (L + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int bps_onebit_threads() { return kThreads; }

const char* bps_onebit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: numel f32; words: L u32; partials: blocks_for(L) f32; out: 2 f32.
int bps_onebit_pack(const void* x, long long numel, int L, void* words,
                    void* partials, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = blocks_for(L);
  pack_kernel<<<nb, kThreads, 0, st>>>(
      static_cast<const float*>(x), numel, L, static_cast<uint32_t*>(words),
      static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pack_finish_kernel<<<1, kThreads, 0, st>>>(
      static_cast<const float*>(partials), nb, static_cast<float>(numel),
      static_cast<float*>(out));
  return cudaGetLastError();
}

// words: L u32; scale: 1 f32 (device); out: numel f32.
int bps_onebit_unpack(const void* words, const void* scale, int L,
                      long long numel, void* out, void* stream) {
  unpack_kernel<<<blocks_for(L), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scale),
      L, numel, static_cast<float*>(out));
  return cudaGetLastError();
}

// words: R x L u32; scales: R f32 (device); out: numel f32.
int bps_onebit_unpack_sum(const void* words, const void* scales, int R,
                          int L, long long numel, void* out, void* stream) {
  unpack_sum_kernel<<<blocks_for(L), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
      R, L, numel, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
