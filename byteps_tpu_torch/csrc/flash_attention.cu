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
// Casts follow the JAX kernels: tiles are read in the input type, products
// are summed in f32, P is rounded to the input type before P.V and before
// dV, dS is rounded to it before dK and dQ, and outputs are rounded to it
// at the end.
//
// Structure.  The TPU runs a sequential grid axis over the reduction
// tiles and carries the sums in VMEM scratch; here each block owns one
// output tile and loops over the reduction tiles itself:
//
//   forward  one block per (bh, Q tile: 128 rows in bf16, 64 in f32),
//            loop over 64-wide K/V tiles;
//   dK/dV    one block per (bh, 64-row K tile), loop over Q tiles;
//   dQ       one block per (bh, 64-row Q tile), loop over K tiles.
//
// No block writes another's output, so there are no atomics and every run
// gives the same bits.  Ragged T is masked in the kernel (rows past T read
// as zero and are never written); D is 32, 64 or 128, and the wrapper pads
// other head sizes with zero columns, which are exact.
//
// Bound (H100 SXM): the work is 2 (forward), 4 (dK/dV) and 3 (dQ) matrix
// products of [Tq, Tk] x D per head, half of them live when causal, against
// 989 TFLOP/s of bf16 tensor cores; the bytes (Q, K, V, O, dO once each)
// are far below the memory bound.
//
// Two designs:
//
// * SIMT (the f32 instances).  256 threads form a 16 x 16
//   grid; thread (ty, tx) owns rows ty + 16i (i < 4) and columns tx + 16j
//   of every 64-wide tile, so a row of a score tile lives in the 16 lanes
//   of one half-warp and its max and sum are shuffles.  Tiles sit in
//   shared memory as f32 with an odd row stride (D + 1, 65), which keeps
//   the strided reads of K^T, P^T and dS^T free of bank conflicts.  The
//   products run as f32 FMAs on the CUDA cores (67 TFLOP/s at most); f32
//   stays there, since TF32 tensor cores would miss the JAX tests' 5e-4.
//
// * Tensor cores (the bf16 instances).  Four warps, each owning 16 rows
//   of the output tile (32 in the forward), run every product as
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 operands, f32
//   accumulators in registers.  Tiles stay bf16 in shared memory, rows
//   padded to D + 8 elements so that ldmatrix's eight 16-byte row reads
//   fall in distinct banks, and arrive by cp.async (16 bytes a thread,
//   zero-filled past T).  The tile the loop walks (Q, dO, lse and delta
//   for dK/dV; K and V for the forward and dQ) is double-buffered: each
//   iteration waits for its tile, passes one __syncthreads, issues the
//   next tile's copy and computes while it lands.
//     The forward gives each warp 32 Q rows (two m tiles, so that each K
//   or V fragment read from shared memory feeds two products), computes
//   S = Q K^T with K as the B operand (plain ldmatrix), and runs
//   _fwd_kernel's online softmax on the accumulators: scale, masks, the
//   row max over the four lanes of a quad, p = exp(s - m_new), l from the
//   f32 p, O rescaled by alpha.  Two adjacent n8 tiles of P repack into one
//   bf16 A fragment (JAX's p.astype(v.dtype)) for O += P V, with V through
//   ldmatrix.trans.  The key tile is 64 wide (kFwdBlockK), since where P
//   is rounded depends on it.
//     dK/dV computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T are
//   accumulators with the warp's K rows as rows; the scale, the masks
//   and exp(s - lse[q]) apply there (lse and delta are per column).  Two
//   adjacent n8 accumulator tiles repack into one bf16 A fragment: that
//   repack is JAX's rounding of P and dS to the input type, and it keeps
//   them out of shared memory.  Then dV += P^T dO and dK += dS^T Q take
//   dO and Q as B operands through ldmatrix.trans.  At D = 128 the Q tile
//   is 32 rows, so that dK, dV (128 registers a thread), S^T and dP^T fit
//   in registers without spilling; at D <= 64 it is 64, and each warp
//   keeps its K and V A fragments in registers through the loop.
//     dQ computes S = Q K^T and dP = dO V^T with K and V as B operands
//   (plain ldmatrix), forms dS in registers, repacks it to A fragments
//   and accumulates dQ += dS K with K through ldmatrix.trans.
//     The masks are evaluated only in tiles that cross the causal
//   diagonal or kv_len.  The dK/dV loop starts at the first live Q tile.
//   Blocks run heavy-first over the whole grid (tile_major_coords): early
//   K tiles for dK/dV, late Q tiles for the forward and dQ, every head's
//   before the next tile of any, so that the light tiles fill the tail.
//   Outputs are rounded to bf16, staged through each warp's own rows of
//   shared memory and stored 16 bytes a lane.  The sum order differs from
//   the plain version's, so results agree with it to rounding, not bit for
//   bit; each run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // SIMT kernels
constexpr int kTile = 64;          // rows of a Q or K tile
constexpr int kLdp = kTile + 1;    // row stride of a score tile in smem
constexpr float kNeg = -1e30f;

constexpr int kMmaThreads = 128;   // tensor-core kernels: 4 warps x 16 rows
constexpr int kPad = 8;            // bf16 padding of a shared-memory row

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
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

  // the kv-tail and causal masks (_mask_block) keep the score at (qrow, kcol)
  __device__ __forceinline__ bool valid(int qrow, int kcol) const {
    return kcol < kv_len && (!causal || q_off + qrow >= kcol);
  }

  // scale, then the masks
  __device__ __forceinline__ float apply(float s, int qrow, int kcol) const {
    return valid(qrow, kcol) ? s * scale : kNeg;
  }

  // whether some score of the tile of Q rows [q0, ...) and K columns
  // [k0, k0 + ncols) is masked (the diagonal or kv_len crosses it); Q rows
  // past T are never stored, so they need no mask
  __device__ __forceinline__ bool partial(int q0, int k0, int ncols) const {
    return k0 + ncols > kv_len || (causal && q_off + q0 < k0 + ncols - 1);
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

// the same grid with the tile as the slow axis: every head's heaviest tile
// starts before any head's lighter ones, so the light tiles fill the tail
// (a longest-first order over the whole grid, not only within a head)
__device__ __forceinline__ void tile_major_coords(int ntiles, bool reverse,
                                                  int* bh, int* tile) {
  const int nbh = gridDim.x / ntiles;
  *bh = blockIdx.x % nbh;
  const int t = blockIdx.x / nbh;
  *tile = reverse ? ntiles - 1 - t : t;
}

// ------------------------------------------------------ forward, f32 SIMT

template <typename T, int D>
__device__ __forceinline__ void fwd_simt(const T* q, const T* k, const T* v,
                                         T* o, float* lse, int tq, int tk,
                                         const Mask& mask) {
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

// ----------------------------------------------------- backward, f32 SIMT

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
__device__ __forceinline__ void dkv_simt(const T* q, const T* k, const T* v,
                                         const T* dout, const float* lse,
                                         const float* delta, T* dk, T* dv,
                                         int tq, int tk, const Mask& mask) {
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
__device__ __forceinline__ void dq_simt(const T* q, const T* k, const T* v,
                                        const T* dout, const float* lse,
                                        const float* delta, T* dq, int tq,
                                        int tk, const Mask& mask) {
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

// ---------------------------------------------- backward, bf16 tensor cores

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without passing through registers;
// with pred false nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's copies have all landed (then __syncthreads for everyone's)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of each matrix i, in r[i], the
// pair at row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 (with .trans: of
// the transposed matrix)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 accumulator.
// Lane l = 4 g + t holds c[g][2t, 2t+1] in c[0..1] and c[g+8][2t, 2t+1] in
// c[2..3]; a[0..3] = a[g][2t..], a[g+8][2t..], a[g][2t+8..], a[g+8][2t+8..]
// (pairs of bf16); b[0..1] = b[2t, 2t+1][g], b[2t+8, 2t+9][g]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest-even bf16 (as astype), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// the accumulators of n8 tiles 2j and 2j + 1 (columns 16j .. 16j + 15 of
// the warp's 16 rows) as the A fragment of k slice j, rounded to bf16
__device__ __forceinline__ void to_a_frag(uint32_t (&a)[4],
                                          const float (&c0)[4],
                                          const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Lane offsets into a shared tile of row stride LD.  kOffA: A fragments
// (rows r0 + [0, 16), columns k0 + [0, 16)) of a row-major tile, and B
// fragments through .trans of a tile stored [k][n] (k rows k0 + [0, 16),
// n columns n0 + [0, 16)): r[0..1] are n tile n0, r[2..3] n tile n0 + 8.
// kOffB: B fragments of a tile stored [n][k] (n rows n0 + [0, 16), k
// columns k0 + [0, 16)): r[0..1] are n tile n0, r[2..3] n tile n0 + 8.
template <int LD> __device__ __forceinline__ int off_a(int lane) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}
template <int LD> __device__ __forceinline__ int off_b(int lane) {
  return ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
}

// rows [row0, row0 + ROWS) of a row-major [nrows, D] bf16 matrix into a
// shared tile of row stride D + kPad, by cp.async; rows past nrows are
// zero-filled (the source address stays in bounds, nothing is read)
template <int ROWS, int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src, int row0,
                                        int nrows) {
  constexpr int kChunks = D / 8;                    // 16 bytes each
  static_assert(ROWS * kChunks % kMmaThreads == 0, "tile shape");
#pragma unroll
  for (int m = 0; m < ROWS * kChunks / kMmaThreads; ++m) {
    const int i = threadIdx.x + m * kMmaThreads;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int gr = row0 + r;
    const bool in = gr < nrows;
    cp_async16(dst + r * (D + kPad) + c, src + (long long)(in ? gr : 0) * D + c,
               in);
  }
}

// per-row f32 values (lse, delta) of rows [row0, row0 + ROWS); zero past
// nrows
template <int ROWS>
__device__ __forceinline__ void cp_rows(float* dst, const float* src,
                                        int row0, int nrows) {
  static_assert(ROWS <= kMmaThreads, "rows");
  if (threadIdx.x < ROWS) {
    const int gr = row0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, src + (gr < nrows ? gr : 0), gr < nrows);
  }
}

// this warp's 16 output rows, [16][D] f32 accumulators in n8 tiles, rounded
// to bf16 and stored to rows [row0, row0 + 16) of dst ([nrows, D]) through
// the warp's own rows of a shared tile (stride D + kPad), 16 bytes a lane;
// rows past nrows are not written
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, bf16* stage,
                                           const float (&acc)[D / 8][4],
                                           int row0, int nrows, int lane) {
  constexpr int LD = D + kPad;
  const int g = lane / 4, t = lane % 4;
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + g * LD + c) =
        pack_bf16(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + c) =
        pack_bf16(acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int m = 0; m < 16 * kChunks / 32; ++m) {
    const int i = lane + 32 * m;
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (row0 + r < nrows)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c);
  }
}

// Q rows of the dK/dV loop's tile: 32 at D = 128, where the dK and dV
// accumulators take 128 registers a thread, else 64
__host__ __device__ constexpr int dkv_bq(int d) { return d > 64 ? 32 : 64; }

template <int D>
__device__ __forceinline__ void dkv_mma(const bf16* q, const bf16* k,
                                        const bf16* v, const bf16* dout,
                                        const float* lse, const float* delta,
                                        bf16* dk, bf16* dv, int tq, int tk,
                                        const Mask& mask) {
  constexpr int LD = D + kPad;
  constexpr int kBq = dkv_bq(D);
  extern __shared__ float smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);        // [kTile][LD]
  bf16* sV = sK + kTile * LD;                      // [kTile][LD]
  bf16* sQ = sV + kTile * LD;                      // [2][kBq][LD]
  bf16* sdO = sQ + 2 * kBq * LD;                   // [2][kBq][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * kBq * LD);   // [2][kBq]
  float* sDl = sL + 2 * kBq;                                   // [2][kBq]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int bh, ik;
  tile_major_coords((tk + kTile - 1) / kTile, false, &bh, &ik);
  const int k0 = ik * kTile;
  const long long qbase = (long long)bh * tq;
  const bf16* qb = q + qbase * D;
  const bf16* dob = dout + qbase * D;

  // live Q tiles [iq0, nq): none when the K tile is wholly past kv_len;
  // under the causal mask, from the first tile whose last row reaches k0
  const int nq = (tq + kBq - 1) / kBq;
  int iq0 = 0;
  if (k0 >= mask.kv_len)
    iq0 = nq;
  else if (mask.causal && k0 - mask.q_off > 0)
    iq0 = min(nq, (k0 - mask.q_off) / kBq);

  auto load_q = [&](int buf, int iq) {
    cp_tile<kBq, D>(sQ + buf * kBq * LD, qb, iq * kBq, tq);
    cp_tile<kBq, D>(sdO + buf * kBq * LD, dob, iq * kBq, tq);
    cp_rows<kBq>(sL + buf * kBq, lse + qbase, iq * kBq, tq);
    cp_rows<kBq>(sDl + buf * kBq, delta + qbase, iq * kBq, tq);
  };
  cp_tile<kTile, D>(sK, k + (long long)bh * tk * D, k0, tk);
  cp_tile<kTile, D>(sV, v + (long long)bh * tk * D, k0, tk);
  if (iq0 < nq) load_q(0, iq0);
  cp_async_commit();

  float acc_dk[D / 8][4] = {}, acc_dv[D / 8][4] = {};
  const bf16* sKw = sK + warp * 16 * LD;           // this warp's K, V rows
  const bf16* sVw = sV + warp * 16 * LD;
  const int oa = off_a<LD>(lane), ob = off_b<LD>(lane);
  const int krow = k0 + warp * 16 + g;             // and krow + 8

  // At D <= 64 the warp's K and V A fragments stay in registers through
  // the loop; at D = 128 the dK and dV accumulators leave no room, and
  // each k slice is read from shared memory when it is used.
  constexpr int kHeld = D <= 64 ? D / 16 : 1;
  uint32_t fk[kHeld][4], fv[kHeld][4];
  if constexpr (kHeld > 1) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kHeld; ++kk) {
      ldsm_x4(fk[kk], sKw + oa + kk * 16);
      ldsm_x4(fv[kk], sVw + oa + kk * 16);
    }
  }

  for (int iq = iq0; iq < nq; ++iq) {
    const int buf = (iq - iq0) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile iq is in; every warp is done with tile iq - 1
    if (iq + 1 < nq) load_q(buf ^ 1, iq + 1);
    cp_async_commit();
    const bf16* cQ = sQ + buf * kBq * LD;
    const bf16* cdO = sdO + buf * kBq * LD;
    const float* cL = sL + buf * kBq;
    const float* cDl = sDl + buf * kBq;
    const int q0 = iq * kBq;

    // S^T = K Q^T and dP^T = V dO^T: [16 K rows] x [kBq Q columns]
    float st[kBq / 8][4] = {}, dpt[kBq / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int f = kHeld > 1 ? kk : 0;
      if constexpr (kHeld == 1) {
        ldsm_x4(fk[0], sKw + oa + kk * 16);
        ldsm_x4(fv[0], sVw + oa + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < kBq / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, cQ + ob + np * 16 * LD + kk * 16);
        mma_bf16(st[2 * np], fk[f], b[0], b[1]);
        mma_bf16(st[2 * np + 1], fk[f], b[2], b[3]);
        ldsm_x4(b, cdO + ob + np * 16 * LD + kk * 16);
        mma_bf16(dpt[2 * np], fv[f], b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], fv[f], b[2], b[3]);
      }
    }

    // P^T = exp(mask(S^T) - lse[q]), dS^T = P^T (dP^T - delta[q]) scale,
    // in place, then rounded to bf16 A fragments
    const bool edge = mask.partial(q0, k0, kTile);
#pragma unroll
    for (int nt = 0; nt < kBq / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        float x = st[nt][e] * mask.scale;
        if (edge && !mask.valid(q0 + qc, krow + 8 * (e >> 1))) x = kNeg;
        const float p = expf(x - cL[qc]);
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - cDl[qc]) * mask.scale;
      }
    }
    uint32_t pf[kBq / 16][4], dsf[kBq / 16][4];
#pragma unroll
    for (int j = 0; j < kBq / 16; ++j) {
      to_a_frag(pf[j], st[2 * j], st[2 * j + 1]);     // P to dO's type
      to_a_frag(dsf[j], dpt[2 * j], dpt[2 * j + 1]);  // dS to Q's type
    }

    // dV += P^T dO and dK += dS^T Q: [16 K rows] x [D]
#pragma unroll
    for (int j = 0; j < kBq / 16; ++j) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, cdO + oa + j * 16 * LD + np * 16);
        mma_bf16(acc_dv[2 * np], pf[j], b[0], b[1]);
        mma_bf16(acc_dv[2 * np + 1], pf[j], b[2], b[3]);
        ldsm_x4_t(b, cQ + oa + j * 16 * LD + np * 16);
        mma_bf16(acc_dk[2 * np], dsf[j], b[0], b[1]);
        mma_bf16(acc_dk[2 * np + 1], dsf[j], b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();   // nothing in flight into sK, sV (no live tile)
  __syncthreads();
  const long long kbase = (long long)bh * tk * D;
  store_rows<D>(dk + kbase, sK + warp * 16 * LD, acc_dk, k0 + warp * 16, tk,
                lane);
  store_rows<D>(dv + kbase, sV + warp * 16 * LD, acc_dv, k0 + warp * 16, tk,
                lane);
}

template <int D>
__device__ __forceinline__ void dq_mma(const bf16* q, const bf16* k,
                                       const bf16* v, const bf16* dout,
                                       const float* lse, const float* delta,
                                       bf16* dq, int tq, int tk,
                                       const Mask& mask) {
  constexpr int LD = D + kPad;
  constexpr int kBk = kTile;
  extern __shared__ float smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);        // [kTile][LD]
  bf16* sdO = sQ + kTile * LD;                     // [kTile][LD]
  bf16* sK = sdO + kTile * LD;                     // [2][kBk][LD]
  bf16* sV = sK + 2 * kBk * LD;                    // [2][kBk][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int bh, iq;
  tile_major_coords((tq + kTile - 1) / kTile, mask.causal, &bh, &iq);
  const int q0 = iq * kTile;
  const long long qbase = (long long)bh * tq;
  const bf16* kb = k + (long long)bh * tk * D;
  const bf16* vb = v + (long long)bh * tk * D;

  // live K tiles [0, nk): before kv_len and, under the causal mask, not
  // wholly in the future of the tile's last row
  int nk = min((tk + kBk - 1) / kBk, (mask.kv_len + kBk - 1) / kBk);
  if (mask.causal) {
    const int last = mask.q_off + q0 + kTile - 1;
    nk = last < 0 ? 0 : min(nk, last / kBk + 1);
  }

  cp_tile<kTile, D>(sQ, q + qbase * D, q0, tq);
  cp_tile<kTile, D>(sdO, dout + qbase * D, q0, tq);
  if (nk > 0) {
    cp_tile<kBk, D>(sK, kb, 0, tk);
    cp_tile<kBk, D>(sV, vb, 0, tk);
  }
  cp_async_commit();

  // lse and delta of this thread's two rows, qrow and qrow + 8
  const int qrow = q0 + warp * 16 + g;
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = qrow + 8 * i < tq;
    lr[i] = in ? lse[qbase + qrow + 8 * i] : 0.0f;
    dr[i] = in ? delta[qbase + qrow + 8 * i] : 0.0f;
  }

  float acc[D / 8][4] = {};
  const bf16* sQw = sQ + warp * 16 * LD;           // this warp's Q, dO rows
  const bf16* sdOw = sdO + warp * 16 * LD;
  const int oa = off_a<LD>(lane), ob = off_b<LD>(lane);

  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();   // tile it is in; every warp is done with tile it - 1
    if (it + 1 < nk) {
      cp_tile<kBk, D>(sK + (buf ^ 1) * kBk * LD, kb, (it + 1) * kBk, tk);
      cp_tile<kBk, D>(sV + (buf ^ 1) * kBk * LD, vb, (it + 1) * kBk, tk);
    }
    cp_async_commit();
    const bf16* cK = sK + buf * kBk * LD;
    const bf16* cV = sV + buf * kBk * LD;
    const int k0 = it * kBk;

    // S = Q K^T and dP = dO V^T: [16 Q rows] x [kBk K columns]
    float s[kBk / 8][4] = {}, dp[kBk / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, sQw + oa + kk * 16);
      ldsm_x4(ado, sdOw + oa + kk * 16);
#pragma unroll
      for (int np = 0; np < kBk / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, cK + ob + np * 16 * LD + kk * 16);
        mma_bf16(s[2 * np], aq, b[0], b[1]);
        mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
        ldsm_x4(b, cV + ob + np * 16 * LD + kk * 16);
        mma_bf16(dp[2 * np], ado, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], ado, b[2], b[3]);
      }
    }

    // dS = exp(mask(S) - lse) (dP - delta) scale, rounded to K's type
    const bool edge = mask.partial(q0, k0, kBk);
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[nt][e] * mask.scale;
        if (edge && !mask.valid(qrow + 8 * i, k0 + nt * 8 + 2 * t + (e & 1)))
          x = kNeg;
        const float p = expf(x - lr[i]);
        dp[nt][e] = p * (dp[nt][e] - dr[i]) * mask.scale;
      }
    }
    uint32_t dsf[kBk / 16][4];
#pragma unroll
    for (int j = 0; j < kBk / 16; ++j)
      to_a_frag(dsf[j], dp[2 * j], dp[2 * j + 1]);

    // dQ += dS K: [16 Q rows] x [D]
#pragma unroll
    for (int j = 0; j < kBk / 16; ++j) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, cK + oa + j * 16 * LD + np * 16);
        mma_bf16(acc[2 * np], dsf[j], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], dsf[j], b[2], b[3]);
      }
    }
  }

  cp_async_wait_all();   // nothing in flight into sQ (no live tile)
  __syncthreads();
  store_rows<D>(dq + qbase * D, sQ + warp * 16 * LD, acc, q0 + warp * 16, tq,
                lane);
}

// ------------------------------------------------ forward, bf16 tensor cores

// Width of the forward's key tile.  P is rounded to bf16 against the
// running row max of each key tile, so the result depends on it: it must
// equal FWD_BLOCK_K in ops/flash_attention.py, whose reference walks the
// keys in blocks of that width.
constexpr int kFwdBlockK = 64;

// Q rows of a forward block: four warps of two 16-row m tiles each, so
// that every K and V fragment read from shared memory feeds two m tiles.
// At D = 128 that takes 255 registers a thread without spilling; Q is read
// from shared memory at each k slice rather than held.  (The Q tile's
// height changes no result: rows are independent.)
constexpr int kFwdMt = 2;
constexpr int kFwdBq = 4 * 16 * kFwdMt;

// the max and the sum of row half i (elements 2i, 2i + 1) of N n8 tiles,
// as trees, so that the dependent chains are log2(2N) long
template <int N>
__device__ __forceinline__ float tree_max(const float (&c)[N][4], int i) {
  float x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) x[n] = fmaxf(c[n][2 * i], c[n][2 * i + 1]);
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n) x[n] = fmaxf(x[n], x[n + w]);
  return x[0];
}

template <int N>
__device__ __forceinline__ float tree_sum(const float (&c)[N][4], int i) {
  float x[N];
#pragma unroll
  for (int n = 0; n < N; ++n) x[n] = c[n][2 * i] + c[n][2 * i + 1];
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int n = 0; n < w; ++n) x[n] += x[n + w];
  return x[0];
}

template <int D>
__device__ __forceinline__ void fwd_mma(const bf16* q, const bf16* k,
                                        const bf16* v, bf16* o, float* lse,
                                        int tq, int tk, const Mask& mask) {
  constexpr int LD = D + kPad;
  constexpr int kMt = kFwdMt, kBq = kFwdBq, kBk = kFwdBlockK;
  extern __shared__ float smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);        // [kBq][LD]
  bf16* sK = sQ + kBq * LD;                        // [2][kBk][LD]
  bf16* sV = sK + 2 * kBk * LD;                    // [2][kBk][LD]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  int bh, iq;
  tile_major_coords((tq + kBq - 1) / kBq, mask.causal, &bh, &iq);
  const int q0 = iq * kBq;
  const int w0 = q0 + warp * kMt * 16;             // the warp's first row
  const long long qbase = (long long)bh * tq;
  const bf16* kb = k + (long long)bh * tk * D;
  const bf16* vb = v + (long long)bh * tk * D;

  // live K tiles [0, nk): before kv_len and, under the causal mask, not
  // wholly in the future of the tile's last row
  int nk = min((tk + kBk - 1) / kBk, (mask.kv_len + kBk - 1) / kBk);
  if (mask.causal) {
    const int last = mask.q_off + q0 + kBq - 1;
    nk = last < 0 ? 0 : min(nk, last / kBk + 1);
  }

  cp_tile<kBq, D>(sQ, q + qbase * D, q0, tq);
  if (nk > 0) {
    cp_tile<kBk, D>(sK, kb, 0, tk);
    cp_tile<kBk, D>(sV, vb, 0, tk);
  }
  cp_async_commit();

  // running max and sum of rows g and g + 8 of each m tile, and O
  float m[kMt][2], l[kMt][2], acc[kMt][D / 8][4] = {};
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mt][i] = kNeg;
      l[mt][i] = 0.0f;
    }
  const bf16* sQw = sQ + (w0 - q0) * LD;           // the warp's Q rows
  const int oa = off_a<LD>(lane), ob = off_b<LD>(lane);

  for (int it = 0; it < nk; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();   // tile it is in; every warp is done with tile it - 1
    if (it + 1 < nk) {
      cp_tile<kBk, D>(sK + (buf ^ 1) * kBk * LD, kb, (it + 1) * kBk, tk);
      cp_tile<kBk, D>(sV + (buf ^ 1) * kBk * LD, vb, (it + 1) * kBk, tk);
    }
    cp_async_commit();
    const bf16* cK = sK + buf * kBk * LD;
    const bf16* cV = sV + buf * kBk * LD;
    const int k0 = it * kBk;

    // S = Q K^T: [16 kMt Q rows] x [kBk K columns], Q as A fragments, K
    // as the B operand (plain ldmatrix)
    float s[kMt][kBk / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
        ldsm_x4(a[mt], sQw + mt * 16 * LD + oa + kk * 16);
#pragma unroll
      for (int np = 0; np < kBk / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, cK + ob + np * 16 * LD + kk * 16);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    // the online softmax of _fwd_kernel, in registers: the scale (rounded
    // before the subtraction, as the plain version rounds it), the masks
    // where the tile crosses the diagonal or kv_len, the new row max over
    // the quad's four lanes, p = exp(s - m_new), l from the f32 p, O
    // rescaled by alpha (skipped, exactly, where every alpha is 1)
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][nt][e] = __fmul_rn(s[mt][nt][e], mask.scale);
    if (mask.partial(w0, k0, kBk)) {
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!mask.valid(w0 + mt * 16 + g + 8 * (e >> 1),
                            k0 + nt * 8 + 2 * t + (e & 1)))
              s[mt][nt][e] = kNeg;
    }
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      float m_new[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = tree_max<kBk / 8>(s[mt], i);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[i] = fmaxf(m[mt][i], mx);
        alpha[i] = expf(m[mt][i] - m_new[i]);
        m[mt][i] = m_new[i];
      }
#pragma unroll
      for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][nt][e] = expf(s[mt][nt][e] - m_new[e >> 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float ps = tree_sum<kBk / 8>(s[mt], i);
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        l[mt][i] = l[mt][i] * alpha[i] + ps;
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          acc[mt][nt][0] *= alpha[0];
          acc[mt][nt][1] *= alpha[0];
          acc[mt][nt][2] *= alpha[1];
          acc[mt][nt][3] *= alpha[1];
        }
      }
    }

    // O += P V: P rounded to bf16 A fragments (p.astype(v.dtype)), V as
    // the B operand through ldmatrix.trans
#pragma unroll
    for (int j = 0; j < kBk / 16; ++j) {
      uint32_t pf[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
        to_a_frag(pf[mt], s[mt][2 * j], s[mt][2 * j + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(b, cV + oa + j * 16 * LD + np * 16);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          mma_bf16(acc[mt][2 * np], pf[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], pf[mt], b[2], b[3]);
        }
      }
    }
  }

  // O = acc / max(l, 1e-30), a division as _fwd_kernel writes it, rounded
  // to bf16 and stored through the warp's own Q rows of shared memory
  // (only this warp read them); lse = m + log(max(l, 1e-30))
  cp_async_wait_all();   // nothing in flight into sQ when no tile is live
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    const int row0 = w0 + mt * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float lc = fmaxf(l[mt][i], 1e-30f);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[mt][nt][2 * i] = acc[mt][nt][2 * i] / lc;
        acc[mt][nt][2 * i + 1] = acc[mt][nt][2 * i + 1] / lc;
      }
      const int row = row0 + g + 8 * i;
      if (t == 0 && row < tq) lse[qbase + row] = m[mt][i] + logf(lc);
    }
    store_rows<D>(o + qbase * D, sQ + (row0 - q0) * LD, acc[mt], row0, tq,
                  lane);
  }
}

// threads and dynamic shared memory of the backward kernels
template <typename T, int D> struct Bwd {           // f32: SIMT
  static constexpr int threads = kThreads;
  static constexpr int dkv_smem =
      (4 * kTile * (D + 1) + 2 * kTile * kLdp + 2 * kTile) * 4;
  static constexpr int dq_smem =
      (4 * kTile * (D + 1) + kTile * kLdp + 2 * kTile) * 4;
};
template <int D> struct Bwd<bf16, D> {              // bf16: tensor cores
  static constexpr int threads = kMmaThreads;
  static constexpr int dkv_smem =
      (2 * kTile + 4 * dkv_bq(D)) * (D + kPad) * 2 + 4 * dkv_bq(D) * 4;
  static constexpr int dq_smem = 6 * kTile * (D + kPad) * 2;
};

// threads, Q rows and dynamic shared memory of a forward block
template <typename T, int D> struct Fwd {           // f32: SIMT
  static constexpr int threads = kThreads;
  static constexpr int bq = kTile;
  static constexpr int smem = (3 * kTile * (D + 1) + kTile * kLdp) * 4;
};
template <int D> struct Fwd<bf16, D> {              // bf16: tensor cores
  static constexpr int threads = kMmaThreads;
  static constexpr int bq = kFwdBq;
  static constexpr int smem = (kFwdBq + 4 * kFwdBlockK) * (D + kPad) * 2;
};

template <typename T, int D>
__global__ void __launch_bounds__(Fwd<T, D>::threads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int tq, int tk, Mask mask) {
  if constexpr (std::is_same<T, bf16>::value)
    fwd_mma<D>(q, k, v, o, lse, tq, tk, mask);
  else
    fwd_simt<T, D>(q, k, v, o, lse, tq, tk, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(Bwd<T, D>::threads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int tq, int tk, Mask mask) {
  if constexpr (std::is_same<T, bf16>::value)
    dkv_mma<D>(q, k, v, dout, lse, delta, dk, dv, tq, tk, mask);
  else
    dkv_simt<T, D>(q, k, v, dout, lse, delta, dk, dv, tq, tk, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(Bwd<T, D>::threads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int tq,
              int tk, Mask mask) {
  if constexpr (std::is_same<T, bf16>::value)
    dq_mma<D>(q, k, v, dout, lse, delta, dq, tq, tk, mask);
  else
    dq_simt<T, D>(q, k, v, dout, lse, delta, dq, tq, tk, mask);
}

// ------------------------------------------------------------------ launch

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

// cp.async and the 16-byte stores of the tensor-core kernels need every
// [BH, T, D] tensor 16-byte aligned (those a kernel does not take are null)
bool aligned16(const Args& a) {
  for (const void* p : {a.q, a.k, a.v, a.dout, (const void*)a.o,
                        (const void*)a.dk, (const void*)a.dv,
                        (const void*)a.dq})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <typename T, int D>
cudaError_t run(int which, const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int nq = (a.tq + kTile - 1) / kTile, nk = (a.tk + kTile - 1) / kTile;
  constexpr int threads = Bwd<T, D>::threads;
  cudaError_t err;
  if (std::is_same<T, bf16>::value && !aligned16(a))
    return cudaErrorMisalignedAddress;
  if (which == 0) {
    using F = Fwd<T, D>;
    err = allow_smem(fwd_kernel<T, D>, F::smem);
    if (err != cudaSuccess) return err;
    const int nqf = (a.tq + F::bq - 1) / F::bq;
    fwd_kernel<T, D><<<a.bh * nqf, F::threads, F::smem, a.stream>>>(
        q, k, v, static_cast<T*>(a.o), a.lse_out, a.tq, a.tk, a.mask);
  } else if (which == 1) {
    constexpr int smem = Bwd<T, D>::dkv_smem;
    err = allow_smem(bwd_dkv_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    bwd_dkv_kernel<T, D><<<a.bh * nk, threads, smem, a.stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.tq, a.tk, a.mask);
  } else {
    constexpr int smem = Bwd<T, D>::dq_smem;
    err = allow_smem(bwd_dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    bwd_dq_kernel<T, D><<<a.bh * nq, threads, smem, a.stream>>>(
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
  if (dtype == 1) return run_d<bf16>(which, d, a);
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
