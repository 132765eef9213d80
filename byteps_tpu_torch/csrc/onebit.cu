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
//   feedback) pays the gap between kernels once instead of twice.  Every
//   input is read with ordinary loads (__ldcs, __ldca), never through the
//   read-only path (__ldg): ptxas moves such a load above the wait, and
//   then it can read what the kernel before has not written yet.
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
// unpack_sum, the merge of R ranks' words (the server half of the
// compressed push_pull: out[i * L + j] = sum over r of sign_r * scale_r),
// takes the tiles of unpack, so a 16,384-float chunk reaches 8 SMs and not
// 2, and its stores are 16 bytes wide:
// - each thread keeps its rows' 4 sums in float4 registers, set to +0.0
//   as the reference's jnp.zeros, and adds the ranks in the order
//   r = 0..R-1, as its fori_loop.  sign * scale is exact (+-scale), and
//   each sum is one IEEE addition per rank in that order, so the result
//   has the reference's bits for any R.  (Starting from rank 0's product
//   instead would give -0.0 where every product is -0.0, a zero scale at
//   R = 1, and the reference +0.0 + -0.0 = +0.0; there is no product to
//   contract into an FMA.)
// - the ranks go in groups of kMergeUnroll (4): a group's 16-byte word
//   vectors and scales are all loaded before the first is added.  Up to
//   4 ranks that is the whole merge; past 4, the next group's loads go
//   out before this group is added, so two groups are in flight.  Ranks
//   at or past R are left out by a predicate that is the same for the
//   whole grid.  The registers do not grow with R, and the order of
//   addition does not change.  Each scale is one load for the whole warp.
// - one launch with programmatic stream serialization, as pack and
//   unpack, and no atomics: each output element is written by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // every kernel's block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWsHead = 32;   // u32 slots of a pack workspace before its
                              // partials (WS_HEAD in onebit_kernels.py)
constexpr int kMergeUnroll = 4;   // ranks in one group of unpack_sum's loads

// Programmatic dependent launch (Hopper): let the next kernel on the
// stream, if launched with programmatic serialization, start its launch
// now, then wait until the kernel before this one has finished and its
// memory is visible.  Every block does this before it touches memory, so
// the kernel sees the stream in order, as without the attribute.  The
// loads after it must be ordinary ones: ptxas hoists a read-only load
// (__ldg, ld.global.nc) above griddepcontrol.wait.
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

// w[0 .. 3], with ordinary loads (ld.global.ca; see enter_stream_order).
template <bool kVec>
__device__ __forceinline__ uint4 load_words(const uint32_t* __restrict__ w) {
  if (kVec) return __ldca(reinterpret_cast<const uint4*>(w));
  return make_uint4(__ldca(w), __ldca(w + 1), __ldca(w + 2), __ldca(w + 3));
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
  const float s = __ldca(scale);             // one request per warp
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

// acc[k] += +-s by the bits of w at row row0 + k, one rank of the merge.
template <int kRpt>
__device__ __forceinline__ void add_rank(float4 (&acc)[kRpt], uint4 w,
                                         float s, int row0) {
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = row0 + k;
    acc[k].x += ((w.x >> i) & 1u) ? s : -s;
    acc[k].y += ((w.y >> i) & 1u) ? s : -s;
    acc[k].z += ((w.z >> i) & 1u) ? s : -s;
    acc[k].w += ((w.w >> i) & 1u) ? s : -s;
  }
}

// The group of ranks r .. r + kMergeUnroll - 1, those at or past R left
// out: its word vectors at j and its scales, then acc += each in order.
template <bool kVec>
__device__ __forceinline__ void load_ranks(uint4 (&w)[kMergeUnroll],
                                           float (&s)[kMergeUnroll],
                                           const uint32_t* __restrict__ words,
                                           const float* __restrict__ scales,
                                           int r, int R, int L, int j) {
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u) {
    if (r + u < R) {
      w[u] = load_words<kVec>(words + (long long)(r + u) * L + j);
      s[u] = __ldca(scales + r + u);
    }
  }
}

template <int kRpt>
__device__ __forceinline__ void add_ranks(float4 (&acc)[kRpt],
                                          const uint4 (&w)[kMergeUnroll],
                                          const float (&s)[kMergeUnroll],
                                          int r, int R, int row0) {
#pragma unroll
  for (int u = 0; u < kMergeUnroll; ++u)
    if (r + u < R) add_rank(acc, w[u], s[u], row0);
}

template <int VW, bool kVec>
__global__ void __launch_bounds__(kThreads)
unpack_sum_kernel(const uint32_t* __restrict__ words,
                  const float* __restrict__ scales, int R, int L,
                  long long numel, float* __restrict__ out) {
  static_assert(VW == 8 || VW == 16 || VW == 32, "VW is 8, 16 or 32");
  constexpr int kRpt = 32 * VW / kThreads;   // rows per thread
  const int row0 = (threadIdx.x / VW) * kRpt;
  const int j = (blockIdx.x * VW + threadIdx.x % VW) * 4;
  enter_stream_order();
  float4 acc[kRpt];
#pragma unroll
  for (int k = 0; k < kRpt; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // the ranks in groups of kMergeUnroll, in order: one group when R is
  // at most kMergeUnroll, else each group's adds wait on loads issued a
  // group earlier, the next group's loads going out before them
  uint4 w[kMergeUnroll], wn[kMergeUnroll];
  float s[kMergeUnroll], sn[kMergeUnroll];
  load_ranks<kVec>(w, s, words, scales, 0, R, L, j);
  if (R <= kMergeUnroll) {
    add_ranks(acc, w, s, 0, R, row0);
  } else {
    for (int r = 0; r < R; r += kMergeUnroll) {
      load_ranks<kVec>(wn, sn, words, scales, r + kMergeUnroll, R, L, j);
      add_ranks(acc, w, s, r, R, row0);
#pragma unroll
      for (int u = 0; u < kMergeUnroll; ++u) {
        w[u] = wn[u];
        s[u] = sn[u];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRpt; ++k)
    store4<kVec>(out, (long long)(row0 + k) * L + j, numel, acc[k]);
}

// The tiles of pack, unpack and unpack_sum: L words in blocks of 4 * vw.
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

template <int VW>
cudaError_t launch_unpack_sum(bool vec, int nb, cudaStream_t st,
                              const uint32_t* words, const float* scales,
                              int R, int L, long long numel, float* out) {
  return launch(vec ? &unpack_sum_kernel<VW, true>
                    : &unpack_sum_kernel<VW, false>,
                nb, st, words, scales, R, L, numel, out);
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

// words: R x L u32; scales: R f32 (device); out: numel f32.  vec: words
// and out are 16-byte aligned.  One launch of L / (4 * vw) blocks.
int bps_onebit_unpack_sum(const void* words, const void* scales, int R,
                          int L, int vw, int vec, long long numel, void* out,
                          void* stream) {
  if (R < 0 || !tiles_ok(L, vw) ||
      (vec && !(aligned16(words) && aligned16(out))))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = L / (4 * vw);
  auto wu = static_cast<const uint32_t*>(words);
  auto sf = static_cast<const float*>(scales);
  auto of = static_cast<float*>(out);
  cudaError_t err;
  if (vw == 8)
    err = launch_unpack_sum<8>(vec, nb, st, wu, sf, R, L, numel, of);
  else if (vw == 16)
    err = launch_unpack_sum<16>(vec, nb, st, wu, sf, R, L, numel, of);
  else
    err = launch_unpack_sum<32>(vec, nb, st, wu, sf, R, L, numel, of);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
