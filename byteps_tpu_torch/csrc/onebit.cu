// Onebit sign compression kernels for Hopper (sm_90a).
//
// They replace the three Pallas TPU kernels of
// byteps_tpu/ops/pallas_kernels.py: pack_kernel replaces onebit_pack
// (_pack_kernel), unpack_kernel onebit_unpack (_unpack_kernel,
// _expand_bits) and unpack_sum_kernel onebit_unpack_sum
// (_unpack_sum_kernel).  The wire layout is theirs: the flat chunk of
// `numel` floats, zero-padded to 32 * L (L = padded_lanes(numel), a
// multiple of 128), is a (32, L) matrix, and bit i of word j is the sign
// (x >= 0) of element i * L + j.  Padding elements are +0.0 and pack as 1
// bits; -0.0 packs as 1 and NaN as 0.  Indices at or past numel read as
// +0.0 and are never written, so the kernels take and produce the
// unpadded chunk and no padded copy exists in device memory.
//
// What bounds them (H100 SXM, 3.35 TB/s): device-memory bytes, at about
// one operation per byte.  pack reads 4 * numel bytes and writes numel / 8;
// unpack reads numel / 8 and writes 4 * numel; unpack_sum reads
// R * numel / 8 and writes 4 * numel.  But the main path's chunks are
// small (16,384 to 1,024,000 floats for ResNet-50: 64 KB to 4 MB), so at
// most 1.2 us of a call is bytes, and what costs is latency: the gap
// between one kernel and the next (about 1.8 us back to back on an H100),
// the number of SMs a chunk reaches, the memory requests a thread has in
// flight, and, for pack, the round trips of the sum across blocks.
//
// What the design of pack and unpack does about that:
// - Tiles.  The matrix is cut into tiles of 4 * VW words by 32 rows
//   (VW = 8, 16 or 32, picked by the wrapper from L; 4 * VW divides L).  A
//   block of 256 threads takes one tile: thread t takes the 4-word vector
//   t % VW and the 32 * VW / 256 rows from (t / VW) * (32 * VW / 256), and
//   moves each row's 4 elements as one 16-byte access, neighbouring threads
//   on neighbouring addresses, all of a thread's rows in flight at once.
//   Warp w holds rows 4w..4w+3 of the tile.  Reads take the read-once hint
//   (__ldcs), unpack's stores the streaming one (__stcs).  A row's vector
//   that straddles numel is read or written one element at a time.  Each
//   kernel has a second instance, kVec = false, that does every access 4
//   bytes at a time, for an input that is not 16-byte aligned.
// - One launch that overlaps the one before it.  Both kernels are launched
//   with programmatic stream serialization: the next kernel's launch starts
//   while this one runs, and each block waits (griddepcontrol.wait) for
//   the kernel before it to finish before it touches memory, so the stream
//   order is kept.  A pack followed by the unpack of its own words (error
//   feedback) pays the gap between kernels once instead of twice.
// - pack's sum across blocks, without atomics or fences.  Each thread ORs
//   its rows' sign bits into 4 words and sums their |x|; the warp's rows are
//   combined by shuffles (OR for the words, a fixed xor tree for the sum),
//   the 8 warps in shared memory, and the 4 words leave as one 16-byte
//   store.  Each block then publishes its partial sum as one 8-byte word
//   with the pack's tag in its upper half (single-copy atomic: a reader
//   sees the tag and the value together).  The last block reads the
//   partials, again until every one carries the tag, adds them in index
//   order, writes out = {sum|x|, sum|x| / numel} and leaves the tag in the
//   workspace for the next pack, whose tag is one more.  The workspace is
//   kept by the wrapper per (device, stream), so packs on one stream use
//   it in stream order and packs on two streams never share one.  Every
//   order of addition is fixed by L, so the scale has the same bits from
//   run to run.  (A ticket taken with atomicAdd after a fence, to elect
//   the last block, costs two more round trips through L2.)  Tags repeat
//   after 2^32 - 1 packs on one workspace.
// - unpack reads its 4 words as one 16-byte load and the scale once per
//   warp, and writes its rows as 16-byte streaming stores of +-scale.
//
// unpack_sum_kernel is the first design: one thread per word j, looping
// over the 32 rows, so a warp touches 32 consecutive floats (128 bytes)
// of row i at each step; it adds ranks in the order r = 0..R-1, as the
// reference's fori_loop does, and since sign * scale is exact its result
// is bit-identical to the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWsHead = 32;   // u32 slots of a pack workspace before its
                              // partials (WS_HEAD in onebit_kernels.py)

// Programmatic dependent launch (Hopper): let the next kernel on the
// stream, if launched with programmatic serialization, start its launch
// now, then wait until the kernel before this one has finished and its
// memory is visible.  Every block does this before it touches memory, so
// the kernel sees the stream in order, as without the attribute.
__device__ __forceinline__ void enter_stream_order() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// x[e .. e+3], the elements at or past numel as +0.0.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ x,
                                        long long e, long long numel) {
  if (e + 4 <= numel) {
    if (kVec) return __ldcs(reinterpret_cast<const float4*>(x + e));
    return make_float4(__ldcs(x + e), __ldcs(x + e + 1), __ldcs(x + e + 2),
                       __ldcs(x + e + 3));
  }
  return make_float4(e < numel ? __ldcs(x + e) : 0.0f,
                     e + 1 < numel ? __ldcs(x + e + 1) : 0.0f,
                     e + 2 < numel ? __ldcs(x + e + 2) : 0.0f,
                     e + 3 < numel ? __ldcs(x + e + 3) : 0.0f);
}

// out[e .. e+3] = v, the elements at or past numel left alone.
template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ out, long long e,
                                       long long numel, float4 v) {
  if (e + 4 <= numel) {
    if (kVec) {
      __stcs(reinterpret_cast<float4*>(out + e), v);
    } else {
      __stcs(out + e, v.x);
      __stcs(out + e + 1, v.y);
      __stcs(out + e + 2, v.z);
      __stcs(out + e + 3, v.w);
    }
    return;
  }
  if (e < numel) __stcs(out + e, v.x);
  if (e + 1 < numel) __stcs(out + e + 1, v.y);
  if (e + 2 < numel) __stcs(out + e + 2, v.z);
  if (e + 3 < numel) __stcs(out + e + 3, v.w);
}

template <bool kVec>
__device__ __forceinline__ uint4 load_words(const uint32_t* __restrict__ w) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(w));
  return make_uint4(__ldg(w), __ldg(w + 1), __ldg(w + 2), __ldg(w + 3));
}

__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// A block's L1 partial as one 8-byte word: the pack's tag above its bits,
// so that a reader sees both or neither.
__device__ __forceinline__ unsigned long long tagged(unsigned tag, float v) {
  return (unsigned long long)tag << 32 | __float_as_uint(v);
}

template <int VW, bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ x, long long numel, int L,
            uint32_t* __restrict__ words, unsigned* __restrict__ ws,
            float* __restrict__ out) {
  static_assert(VW == 8 || VW == 16 || VW == 32, "VW is 8, 16 or 32");
  constexpr int kRpt = 32 * VW / kThreads;   // rows per thread
  __shared__ uint4 sh_words[kWarps][VW];
  __shared__ float sh_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (threadIdx.x / VW) * kRpt;
  const int j = (blockIdx.x * VW + threadIdx.x % VW) * 4;
  enter_stream_order();

  float4 q[kRpt];
#pragma unroll
  for (int k = 0; k < kRpt; ++k)
    q[k] = load4<kVec>(x, (long long)(row0 + k) * L + j, numel);
  // this pack's tag: one more than the last pack's on this workspace, and
  // never 0, which the partials of a fresh workspace hold
  unsigned tag = (warp == 0 ? load_relaxed(ws) : 0u) + 1u;
  tag += tag == 0u;
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = row0 + k;
    w0 |= (uint32_t)(q[k].x >= 0.0f) << i;
    w1 |= (uint32_t)(q[k].y >= 0.0f) << i;
    w2 |= (uint32_t)(q[k].z >= 0.0f) << i;
    w3 |= (uint32_t)(q[k].w >= 0.0f) << i;
    acc += fabsf(q[k].x);
    acc += fabsf(q[k].y);
    acc += fabsf(q[k].z);
    acc += fabsf(q[k].w);
  }
  // the warp's other rows of the same vector sit at lanes VW, 2 VW, ... away
#pragma unroll
  for (int m = VW; m < 32; m <<= 1) {
    w0 |= __shfl_xor_sync(kFull, w0, m);
    w1 |= __shfl_xor_sync(kFull, w1, m);
    w2 |= __shfl_xor_sync(kFull, w2, m);
    w3 |= __shfl_xor_sync(kFull, w3, m);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(kFull, acc, m);
  if (lane < VW) sh_words[warp][lane] = make_uint4(w0, w1, w2, w3);
  if (lane == 0) sh_sums[warp] = acc;
  __syncthreads();
  if (warp != 0) return;

  // warp 0: the block's words, then its L1 partial
  if (lane < VW) {
    uint4 w = sh_words[0][lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      const uint4 o = sh_words[k][lane];
      w.x |= o.x;
      w.y |= o.y;
      w.z |= o.z;
      w.w |= o.w;
    }
    reinterpret_cast<uint4*>(words)[blockIdx.x * VW + lane] = w;
  }
  float part = lane < kWarps ? sh_sums[lane] : 0.0f;
#pragma unroll
  for (int m = kWarps / 2; m > 0; m >>= 1)
    part += __shfl_xor_sync(kFull, part, m);

  const int nb = gridDim.x;
  float total = 0.0f;
  // Every block publishes its partial with the tag; the last block waits
  // until it has read every partial of this pack, adds them in index
  // order, and moves the tag on for the next pack.
  auto partials = reinterpret_cast<unsigned long long*>(ws + kWsHead);
  if (lane == 0) store_relaxed(partials + blockIdx.x, tagged(tag, part));
  if (blockIdx.x != nb - 1) return;
  for (int b0 = 0; b0 < nb; b0 += 256) {
    // this lane's 8 partials of the batch, read together until each
    // carries this pack's tag
    unsigned long long v[8];
    bool ready;
    do {
      ready = true;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int b = b0 + k * 32 + lane;
        v[k] = b < nb ? load_relaxed(partials + b) : tagged(tag, 0.0f);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) ready &= (unsigned)(v[k] >> 32) == tag;
    } while (!ready);
#pragma unroll
    for (int k = 0; k < 8; ++k) total += __uint_as_float((unsigned)v[k]);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) total += __shfl_xor_sync(kFull, total, m);
  if (lane == 0) {
    out[0] = total;
    // IEEE division, as the reference's abs_sum / numel
    out[1] = total / static_cast<float>(numel);
    ws[0] = tag;
  }
}

template <int VW, bool kVec>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ words,
              const float* __restrict__ scale, int L, long long numel,
              float* __restrict__ out) {
  static_assert(VW == 8 || VW == 16 || VW == 32, "VW is 8, 16 or 32");
  constexpr int kRpt = 32 * VW / kThreads;   // rows per thread
  const int row0 = (threadIdx.x / VW) * kRpt;
  const int j = (blockIdx.x * VW + threadIdx.x % VW) * 4;
  enter_stream_order();
  const float s = __ldg(scale);              // one request per warp
  const uint4 w = load_words<kVec>(words + j);
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = row0 + k;
    const float4 v = make_float4(((w.x >> i) & 1u) ? s : -s,
                                 ((w.y >> i) & 1u) ? s : -s,
                                 ((w.z >> i) & 1u) ? s : -s,
                                 ((w.w >> i) & 1u) ? s : -s);
    store4<kVec>(out, (long long)i * L + j, numel, v);
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

// The tiles of pack and unpack: L words in blocks of 4 * vw.
bool tiles_ok(int L, int vw) {
  return (vw == 8 || vw == 16 || vw == 32) && L > 0 && L % (4 * vw) == 0;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One launch of nb blocks with programmatic stream serialization, so that
// it overlaps the end of the kernel before it (enter_stream_order).
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int nb, cudaStream_t st,
                   Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int VW>
cudaError_t launch_pack(bool vec, int nb, cudaStream_t st, const float* x,
                        long long numel, int L, uint32_t* words,
                        unsigned* ws, float* out) {
  return launch(vec ? &pack_kernel<VW, true> : &pack_kernel<VW, false>, nb,
                st, x, numel, L, words, ws, out);
}

template <int VW>
cudaError_t launch_unpack(bool vec, int nb, cudaStream_t st,
                          const uint32_t* words, const float* scale, int L,
                          long long numel, float* out) {
  return launch(vec ? &unpack_kernel<VW, true> : &unpack_kernel<VW, false>,
                nb, st, words, scale, L, numel, out);
}

}  // namespace

extern "C" {

const char* bps_onebit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: numel f32; words: L u32 (16-byte aligned); ws: the stream's
// workspace, kWsHead u32 then L / (4 * vw) u64 (zeroed when made, kept by
// the wrapper per device and stream); out: 2 f32.  vec: x is 16-byte
// aligned.  One launch of L / (4 * vw) blocks.
int bps_onebit_pack(const void* x, long long numel, int L, int vw, int vec,
                    void* words, void* ws, void* out, void* stream) {
  if (!tiles_ok(L, vw) || !aligned16(words) || !aligned16(ws) ||
      (vec && !aligned16(x)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = L / (4 * vw);
  auto xf = static_cast<const float*>(x);
  auto wu = static_cast<uint32_t*>(words);
  auto wsu = static_cast<unsigned*>(ws);
  auto of = static_cast<float*>(out);
  cudaError_t err;
  if (vw == 8)
    err = launch_pack<8>(vec, nb, st, xf, numel, L, wu, wsu, of);
  else if (vw == 16)
    err = launch_pack<16>(vec, nb, st, xf, numel, L, wu, wsu, of);
  else
    err = launch_pack<32>(vec, nb, st, xf, numel, L, wu, wsu, of);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// words: L u32; scale: 1 f32 (device); out: numel f32.  vec: words and
// out are 16-byte aligned.  One launch of L / (4 * vw) blocks.
int bps_onebit_unpack(const void* words, const void* scale, int L, int vw,
                      int vec, long long numel, void* out, void* stream) {
  if (!tiles_ok(L, vw) || (vec && !(aligned16(words) && aligned16(out))))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = L / (4 * vw);
  auto wu = static_cast<const uint32_t*>(words);
  auto sf = static_cast<const float*>(scale);
  auto of = static_cast<float*>(out);
  cudaError_t err;
  if (vw == 8)
    err = launch_unpack<8>(vec, nb, st, wu, sf, L, numel, of);
  else if (vw == 16)
    err = launch_unpack<16>(vec, nb, st, wu, sf, L, numel, of);
  else
    err = launch_unpack<32>(vec, nb, st, wu, sf, L, numel, of);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// words: R x L u32; scales: R f32 (device); out: numel f32.
int bps_onebit_unpack_sum(const void* words, const void* scales, int R,
                          int L, long long numel, void* out, void* stream) {
  unpack_sum_kernel<<<(L + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const float*>(scales),
      R, L, numel, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
