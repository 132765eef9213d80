// Flash attention kernels for Hopper (sm_90a): forward, dK/dV and dQ.
//
// They replace the three Pallas TPU kernels of
// byteps_tpu/ops/flash_attention.py: the forward (_fwd, _fwd_kernel,
// _mask_block), and the two backward kernels of _bwd_impl
// (_bwd_dkv_kernel, _bwd_dq_kernel).  What they compute is theirs:
//
//   forward  online softmax over K/V tiles with running (m, l, acc) in
//            f32; O = acc / max(l, 1e-30) in the input type and
//            lse = m + log(max(l, 1e-30)) in f32;
//   dK/dV    P recomputed from (Q, K, lse); dV += P^T dO and
//            dK += dS^T Q, dS = P * (dO V^T - delta) * scale, summed over
//            the Q tiles;
//   dQ       dQ += dS K, summed over the K tiles.
//
// Scores are masked to the finite -1e30 (kv tail: col >= kv_len; causal:
// q_off + row < col), and a K tile wholly in the future of a Q tile is
// skipped (the Pallas `live` predicate).  q_off and kv_len are runtime
// arguments, so one build serves every causal offset.
//
// Casts follow the JAX kernels: tiles are read in the input type and
// widened to f32 (exact), products are summed in f32, P is rounded to the
// input type before P.V and before dV, dS is rounded to it before dK and
// dQ, and outputs are rounded to it at the end.
//
// Structure.  The TPU runs a sequential grid axis over the reduction
// tiles and carries the sums in VMEM scratch; here each block owns one
// output tile and loops over the reduction tiles itself:
//
//   forward  one block per (bh, 64-row Q tile), loop over K/V tiles;
//   dK/dV    one block per (bh, 64-row K tile), loop over Q tiles;
//   dQ       one block per (bh, 64-row Q tile), loop over K tiles.
//
// No block writes another's output, so there are no atomics and every run
// gives the same bits.  256 threads form a 16 x 16 grid; thread (ty, tx)
// owns rows ty + 16i (i < 4) and columns tx + 16j of every 64-wide tile,
// so a row of a score tile lives in the 16 lanes of one half-warp and its
// max and sum are shuffles.  Tiles sit in shared memory as f32 with an odd
// row stride (D + 1, 65), which keeps the strided reads of K^T, P^T and
// dS^T free of bank conflicts.  Ragged T is masked in the kernel (rows past
// T read as zero and are never written); D is 32, 64 or 128, and the
// wrapper pads other head sizes with zero columns, which are exact.
//
// Bound (H100 SXM): the work is 2 (forward), 4 (dK/dV) and 3 (dQ) matrix
// products of [Tq, Tk] x D per head, half of them live when causal, against
// 989 TFLOP/s of bf16 tensor cores; the bytes (Q, K, V, O, dO once each)
// are far below the memory bound.  These kernels are the plain first
// version: the products run as f32 FMAs on the CUDA cores (67 TFLOP/s at
// most), fed from shared memory.  Tensor-core MMA, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // rows of a Q or K tile
constexpr int kLdp = kTile + 1;    // row stride of a score tile in smem
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype
}

// the value x takes when cast to T and read back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// rows [row0, row0 + kTile) of a row-major [nrows, D] matrix into smem
// [kTile][D + 1] as f32; rows at or past nrows read as zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int nrows) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int gr = row0 + r;
    dst[r * (D + 1) + c] =
        gr < nrows ? to_f<T>(src[(long long)gr * D + c]) : 0.0f;
  }
}

// per-row f32 values (lse, delta) of rows [row0, row0 + kTile)
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int nrows) {
  if (threadIdx.x < kTile) {
    const int gr = row0 + threadIdx.x;
    dst[threadIdx.x] = gr < nrows ? src[gr] : 0.0f;
  }
}

// acc[i][j] += sum_d A[ty + 16i][d] * B[tx + 16j][d]   (A B^T, [64, 64])
template <int D>
__device__ __forceinline__ void mm_abt(float (&acc)[4][4], const float* a,
                                       const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c P[ty + 16i][c] * B[c][tx + 16j]   (P B, [64, D])
template <int D>
__device__ __forceinline__ void mm_ab(float (&acc)[4][D / 16], const float* p,
                                      const float* b, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float av[4], bv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = p[(ty + 16 * i) * kLdp + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bv[j] = b[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[r][ty + 16i] * B[r][tx + 16j]   (P^T B, [64, D])
template <int D>
__device__ __forceinline__ void mm_atb(float (&acc)[4][D / 16],
                                       const float* p, const float* b, int ty,
                                       int tx) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float av[4], bv[D / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = p[r * kLdp + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) bv[j] = b[r * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// max and sum over the 16 lanes that hold one score row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Mask {
  float scale;
  int causal, q_off, kv_len;

  // the Pallas `live` predicate, plus tiles wholly past kv_len; skipping
  // those is exact, since kv_len >= 1 (the wrapper requires it) leaves key
  // 0 live, so their P is 0 against a finite row max
  __device__ __forceinline__ bool live(int q0, int k0) const {
    return k0 < kv_len && (!causal || k0 <= q_off + q0 + kTile - 1);
  }

  // scale, then the kv-tail and causal masks (_mask_block)
  __device__ __forceinline__ float apply(float s, int qrow, int kcol) const {
    const bool valid = kcol < kv_len && (!causal || q_off + qrow >= kcol);
    return valid ? s * scale : kNeg;
  }
};

// tiles of a (bh, tile) grid flattened into blockIdx.x; heavy-first
// ordering for causal Q tiles (later tiles see more keys)
__device__ __forceinline__ void block_coords(int ntiles, bool reverse,
                                             int* bh, int* tile) {
  *bh = blockIdx.x / ntiles;
  const int t = blockIdx.x % ntiles;
  *tile = reverse ? ntiles - 1 - t : t;
}

// ----------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int tq, int tk, Mask mask) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sP = sV + kTile * (D + 1);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  int bh, iq;
  block_coords((tq + kTile - 1) / kTile, mask.causal, &bh, &iq);
  const int q0 = iq * kTile;
  const T* qb = q + (long long)bh * tq * D;
  const T* kb = k + (long long)bh * tk * D;
  const T* vb = v + (long long)bh * tk * D;

  load_tile<T, D>(sQ, qb, q0, tq);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < tk && mask.live(q0, k0); k0 += kTile) {
    __syncthreads();                       // last tile's readers are done
    load_tile<T, D>(sK, kb, k0, tk);
    load_tile<T, D>(sV, vb, k0, tk);
    __syncthreads();
    float s[4][4] = {};
    mm_abt<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = mask.apply(s[i][j], q0 + r, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[r * kLdp + tx + 16 * j] = round_to<T>(p);   // P to V's type
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_ab<D>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      o[((long long)bh * tq + row) * D + tx + 16 * j] =
          from_f<T>(acc[i][j] / lc);
    if (tx == 0) lse[(long long)bh * tq + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------------------------------- backward

// P = exp(mask(Q K^T) - lse) and dS = P * (dO V^T - delta) * scale for one
// (Q tile, K tile) pair; P and dS land in smem rounded to T
template <typename T, int D>
__device__ __forceinline__ void recompute_p_ds(
    const float* sQ, const float* sK, const float* sV, const float* sdO,
    const float* sL, const float* sDelta, float* sP, float* sdS, int q0,
    int k0, const Mask& mask, int ty, int tx) {
  float s[4][4] = {}, dp[4][4] = {};
  mm_abt<D>(s, sQ, sK, ty, tx);
  mm_abt<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p = expf(mask.apply(s[i][j], q0 + r, k0 + c) - sL[r]);
      const float ds = p * (dp[i][j] - sDelta[r]) * mask.scale;
      if (sP != nullptr) sP[r * kLdp + c] = round_to<T>(p);   // to dO's type
      sdS[r * kLdp + c] = round_to<T>(ds);                    // to Q's/K's
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int tq, int tk, Mask mask) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * (D + 1);
  float* sQ = sV + kTile * (D + 1);
  float* sdO = sQ + kTile * (D + 1);
  float* sP = sdO + kTile * (D + 1);
  float* sdS = sP + kTile * kLdp;
  float* sL = sdS + kTile * kLdp;
  float* sDelta = sL + kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  int bh, ik;
  block_coords((tk + kTile - 1) / kTile, false, &bh, &ik);
  const int k0 = ik * kTile;
  const long long qbase = (long long)bh * tq;

  load_tile<T, D>(sK, k + (long long)bh * tk * D, k0, tk);
  load_tile<T, D>(sV, v + (long long)bh * tk * D, k0, tk);
  float dk_acc[4][D / 16] = {}, dv_acc[4][D / 16] = {};

  for (int q0 = 0; q0 < tq; q0 += kTile) {
    if (!mask.live(q0, k0)) continue;      // uniform over the block
    __syncthreads();
    load_tile<T, D>(sQ, q + qbase * D, q0, tq);
    load_tile<T, D>(sdO, dout + qbase * D, q0, tq);
    load_rows(sL, lse + qbase, q0, tq);
    load_rows(sDelta, delta + qbase, q0, tq);
    __syncthreads();
    recompute_p_ds<T, D>(sQ, sK, sV, sdO, sL, sDelta, sP, sdS, q0, k0, mask,
                         ty, tx);
    __syncthreads();
    mm_atb<D>(dv_acc, sP, sdO, ty, tx);   // dV += P^T dO
    mm_atb<D>(dk_acc, sdS, sQ, ty, tx);   // dK += dS^T Q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= tk) continue;
    const long long base = ((long long)bh * tk + row) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[base + tx + 16 * j] = from_f<T>(dk_acc[i][j]);
      dv[base + tx + 16 * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int tq,
              int tk, Mask mask) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * (D + 1);
  float* sK = sdO + kTile * (D + 1);
  float* sV = sK + kTile * (D + 1);
  float* sdS = sV + kTile * (D + 1);
  float* sL = sdS + kTile * kLdp;
  float* sDelta = sL + kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  int bh, iq;
  block_coords((tq + kTile - 1) / kTile, mask.causal, &bh, &iq);
  const int q0 = iq * kTile;
  const long long qbase = (long long)bh * tq;
  const T* kb = k + (long long)bh * tk * D;
  const T* vb = v + (long long)bh * tk * D;

  load_tile<T, D>(sQ, q + qbase * D, q0, tq);
  load_tile<T, D>(sdO, dout + qbase * D, q0, tq);
  load_rows(sL, lse + qbase, q0, tq);
  load_rows(sDelta, delta + qbase, q0, tq);
  float dq_acc[4][D / 16] = {};

  for (int k0 = 0; k0 < tk && mask.live(q0, k0); k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(sK, kb, k0, tk);
    load_tile<T, D>(sV, vb, k0, tk);
    __syncthreads();
    recompute_p_ds<T, D>(sQ, sK, sV, sdO, sL, sDelta, nullptr, sdS, q0, k0,
                         mask, ty, tx);
    __syncthreads();
    mm_ab<D>(dq_acc, sdS, sK, ty, tx);    // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= tq) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      dq[(qbase + row) * D + tx + 16 * j] = from_f<T>(dq_acc[i][j]);
  }
}

// ------------------------------------------------------------------ launch

constexpr int fwd_smem(int d) { return (3 * kTile * (d + 1) + kTile * kLdp) * 4; }
constexpr int dkv_smem(int d) {
  return (4 * kTile * (d + 1) + 2 * kTile * kLdp + 2 * kTile) * 4;
}
constexpr int dq_smem(int d) {
  return (4 * kTile * (d + 1) + kTile * kLdp + 2 * kTile) * 4;
}

// dynamic shared memory above 48 KB must be allowed once per kernel
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *o, *dk, *dv, *dq;
  float* lse_out;
  int bh, tq, tk;
  Mask mask;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t run(int which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int nq = (a.tq + kTile - 1) / kTile, nk = (a.tk + kTile - 1) / kTile;
  cudaError_t err;
  if (which == 0) {
    err = allow_smem(fwd_kernel<T, D>, fwd_smem(D));
    if (err != cudaSuccess) return err;
    fwd_kernel<T, D><<<a.bh * nq, kThreads, fwd_smem(D), a.stream>>>(
        q, k, v, static_cast<T*>(a.o), a.lse_out, a.tq, a.tk, a.mask);
  } else if (which == 1) {
    err = allow_smem(bwd_dkv_kernel<T, D>, dkv_smem(D));
    if (err != cudaSuccess) return err;
    bwd_dkv_kernel<T, D><<<a.bh * nk, kThreads, dkv_smem(D), a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.tq, a.tk, a.mask);
  } else {
    err = allow_smem(bwd_dq_kernel<T, D>, dq_smem(D));
    if (err != cudaSuccess) return err;
    bwd_dq_kernel<T, D><<<a.bh * nq, kThreads, dq_smem(D), a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.tq, a.tk,
        a.mask);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(int which, int d, const Args& a) {
  switch (d) {
    case 32: return run<T, 32>(which, a);
    case 64: return run<T, 64>(which, a);
    case 128: return run<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16
int dispatch(int which, int dtype, int d, const Args& a) {
  if (a.bh <= 0 || a.tq <= 0 || a.tk <= 0) return 0;
  if (dtype == 0) return run_d<float>(which, d, a);
  if (dtype == 1) return run_d<__nv_bfloat16>(which, d, a);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, int bh, int tq,
               int tk, float scale, int causal, int q_off, int kv_len,
               void* stream) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bh = bh;
  a.tq = tq;
  a.tk = tk;
  a.mask = Mask{scale, causal, q_off, kv_len};
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

extern "C" {

const char* bps_flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: [bh, tq, d], k, v: [bh, tk, d] (dtype); o: [bh, tq, d]; lse: [bh, tq] f32
int bps_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int bh, int tq, int tk, int d, int dtype,
                  float scale, int causal, int q_off, int kv_len,
                  void* stream) {
  Args a = make_args(q, k, v, bh, tq, tk, scale, causal, q_off, kv_len,
                     stream);
  a.o = o;
  a.lse_out = static_cast<float*>(lse);
  return dispatch(0, dtype, d, a);
}

// + dout: [bh, tq, d], lse, delta: [bh, tq] f32; dk, dv: [bh, tk, d]
int bps_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int tq, int tk, int d,
                      int dtype, float scale, int causal, int q_off,
                      int kv_len, void* stream) {
  Args a = make_args(q, k, v, bh, tq, tk, scale, causal, q_off, kv_len,
                     stream);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  return dispatch(1, dtype, d, a);
}

// same inputs; dq: [bh, tq, d]
int bps_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int tq, int tk, int d, int dtype,
                     float scale, int causal, int q_off, int kv_len,
                     void* stream) {
  Args a = make_args(q, k, v, bh, tq, tk, scale, causal, q_off, kv_len,
                     stream);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  return dispatch(2, dtype, d, a);
}

}  // extern "C"
