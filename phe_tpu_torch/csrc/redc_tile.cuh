// The REDC tile: Montgomery products over 14-bit redundant limbs for E
// rows a block, both constant products of each reduction on the int8
// tensor cores (kMxu), or, for a context without REDC matrices, on the
// CUDA cores' integer pipe (the integer-pipe body, below). mont_mul.cu
// runs one product a row on it, mont_pow.cu a whole windowed modexp a row.
//
// What a product computes: for a, b < 2.01 M with limbs in [0, 2^14] and
// R = 2^(14 L) >= 2^16 M, a result congruent to a b R^-1 mod M with limbs
// in [0, 2^14] and value < 1.01 M (phe_tpu's contract for its Pallas
// kernels): value-equal to montgomery.mont_mul_plain, not limb-equal.
//
// It is phe_tpu's MXU formulation (pallas_modexp.py _mont_mul_into,
// :155-190): T = a b on the CUDA cores; q = T_lo M' mod R as w_mq [2L, 2L]
// times the 2L block-order 7-bit digits of T_lo, and q M as w_m [4L, 2L]
// times the digits of q, both as mma.sync m16n8k32 s8 x s8 -> s32 with the
// block's E rows as N; then U = T + q M and U / R. The matrices are
// phe_tpu's own (ops/montgomery.py build_redc_matrices), packed by the
// host in A-fragment order (cuda_rns.pack_blocks: two row blocks, the low
// and the high digit of each output limb, so a warp's two accumulators of
// one slab hold both digits of the same limbs and the epilogue recombines
// them from registers), streamed from L2 once per block-product by
// 16-byte cp.async copies kStages - 1 K-steps ahead into a per-warp ring
// in shared memory. Signedness: a limb of exactly 2^14 has a high digit of
// 128, so the B operand's high digits are biased by -64 into [-64, 64], as
// phe_tpu's are, and the epilogue adds the compensation vectors c_mq, c_m
// (64 times the high-digit columns' sums). Every int32 MMA sum is below
// 2L * 127 * 128 (3.8e7 at L = 1,176); the epilogue recombines
// lo + (hi << 7) in 64 bits, so no L is refused (phe_tpu's uint32 slots
// stop at L = 507).
//
// a * b: each thread computes a run of kRun adjacent columns of one row in
// registers. Its i loop walks kRun operand limbs at a time: kRun limbs of
// a and 2 kRun - 1 of b in registers feed kRun^2 multiply-adds (32-bit
// partial sums of kRun products below 2^28, folded into 64-bit columns),
// and each step loads kRun new limbs of each operand. Operand rows carry
// kPad zero limbs either side, so no load is bounds-checked. A squaring
// sums each cross term once, doubled, plus the diagonal. A warp's lanes
// hold E rows of the same run (at E = 32) or adjacent runs, so their loop
// bounds agree.
//
// Carries: a run is normalised in registers as it is produced (its
// carry-out, below 2^26, goes to shared memory); a second pass ripples the
// previous run's carry-out through each run (leaving a carry of 0 or 1),
// and that bit is added to the next run's first limb by whoever reads it
// next, so limbs end in [0, 2^14]. T, q (mod R) and U each take these two
// passes; U's low half is 0 or exactly R, so U / R is its high half plus
// one iff any low limb is non-zero (a per-row flag). Every phase works on
// all live rows between block barriers: 12 barriers a product, shared by
// the block's rows.
//
// The integer-pipe body (kMxu = false) computes what phe_tpu's mxu=False
// branch of _mont_mul_into computes (pallas_modexp.py :192-196, its
// kernels' branch at :200, :325, :469): m_q = the low L limbs of T_lo M',
// then T + m_q M, then the exact / R of _redc_tail, all three products on
// the CUDA cores with the a * b machinery above (runs of kRun columns from
// registers, 64-bit column sums). T_lo, then q, take the accumulator rows
// as their operand (a is dead once T = a b), M' and M one shared row each,
// read by every row slot; q is normalised run by run and rippled (its top
// carry dropped: mod R), and T + q M is normalised in place over T, so the
// same two carry passes and the same / R end the product. No matrix ring
// and no digit rows: smem_bytes(L, E, false) is 215,080 bytes at L = 296,
// E = 32 and 217,640 at L = 1,176, E = 8.
//
// Limb counts: any multiple of kRun. At L = 8 the MMAs' one K-step holds
// the 16 digits and 16 zero digits of padding (the digit rows are zeroed
// with the block and only [0, 2L) is ever written), q's one slab holds L
// rows and 8 zero rows of padding, and the operand pads (kPad = 14 > L)
// cover every a * b window; the tile walk in
// tests/test_torch_mont_pow_tiles.py runs that width.
//
// Layout: shared memory holds per row slot the accumulator (with its
// pads) and the two carry arrays, a region the MMA phases borrow as their
// ring; then T, a scratch H (the factor, then q's two halves, then U's
// carry half), the flag and the digit row: smem_bytes(L, E), 232,448
// bytes at L = 296, E = 32 and 227,072 at L = 1,176, E = 8 (the largest L
// whose E = 8 block fits is 1,200). A block holds `live` of its E row
// slots; the other slots' MMA columns read zero digits and their results
// are never read. Twelve warps a block, one block an SM.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace phe {

constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;      // columns of one a*b job; runs of the carry passes
constexpr int kPad = 14;     // zero limbs either side of an operand row
constexpr int kStages = 4;   // K-steps of A fragments in flight (the ring)
constexpr int kSmemLimit = 232448;
constexpr unsigned int kMask = (1u << 14) - 1;

// Strides in 32-bit words (odd, so E rows of one column fall in E banks)
// and bytes; ops/cuda_modexp.py's _pow_smem mirrors them.
__host__ __device__ inline int op_stride(int L) { return L + 2 * kPad + 1; }
__host__ __device__ inline int wide_stride(int L) { return 2 * L + 1; }
__host__ __device__ inline int h_stride(int L) {
  return (2 * L > L + 2 * kPad ? 2 * L : L + 2 * kPad) + 1;
}
__host__ __device__ inline int n_runs(int L) { return 2 * L / kRun; }
__host__ __device__ inline int k_pad(int L) { return (2 * L + 31) / 32 * 32; }
__host__ __device__ inline int dig_stride(int L) { return k_pad(L) + 16; }
__host__ __device__ inline int q_slabs(int L) { return (L + 15) / 16; }
// The accumulator rows and the carry arrays come first. The int8 body's
// MMA phases use that region, idle then, as their ring (kWarps x kStages
// slots of 1 KB), so with mxu it is never smaller than the ring.
__host__ __device__ inline size_t ring_region(int L, int elems, bool mxu) {
  const size_t rows = 4 * static_cast<size_t>(elems) *
                      (op_stride(L) + 2 * n_runs(L));
  const size_t ring = static_cast<size_t>(kWarps) * kStages * 64 * 16;
  return rows > ring || !mxu ? rows : ring;
}
// Then per row T, H and the flag; then the int8 body's digit rows, or the
// integer-pipe body's two constant rows (M', M), padded as operands.
inline size_t smem_bytes(int L, int elems, bool mxu) {
  const size_t rows = static_cast<size_t>(elems) * 4 *
                      (static_cast<size_t>(wide_stride(L)) + h_stride(L) + 1);
  return ring_region(L, elems, mxu) + rows +
         (mxu ? static_cast<size_t>(elems) * dig_stride(L)
              : 2 * 4 * static_cast<size_t>(op_stride(L)));
}

// The reduction's constants in device memory: for the int8 body the packed
// matrices (w_mq, w_m in fragment order) and their compensation vectors
// c_mq, c_m; for the integer-pipe body M' and M, int64 [L] limbs.
struct RedcConsts {
  const int *wq, *wm, *cq, *cm;
  const int64_t *mp, *m;
};

// c += A B for one m16n8k32 tile: A's four registers, B's two.
__device__ __forceinline__ void mma_s8(int* c, const int4& a, unsigned int b0,
                                       unsigned int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 16 bytes from device memory into shared memory, asynchronously, past
// L1 (cp.async.cg); completion is awaited per thread by commit group.
__device__ __forceinline__ void cp_async16(int4* smem, const int4* gmem) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kMxu: the int8 tensor-core body (true) or the integer-pipe one (false).
template <int E, bool kMxu>
struct RedcTile {
  static constexpr int kTiles = E / 8;  // n-tiles of 8 rows
  int L, sa, st, sh, nr, ds, ksteps, live;
  unsigned int* acc;   // [E, sa]: limbs at [kPad, kPad + L), zero pads
  unsigned int* T;     // [E, st]: T = a b, then U
  unsigned int* H;     // [E, sh]: the factor (padded as acc), q, U's carries
  unsigned int* c1;    // [E, nr]: each run's carry-out
  unsigned int* c2;    // [E, nr]: each run's carry after the ripple
  unsigned int* flag;  // [E]: U's low half is non-zero
  unsigned char* dig;  // [E, ds]: the B operand's digits; [2L, ds) zero
  unsigned int* mq;    // [sa]: M', padded as acc (integer pipe)
  unsigned int* mm;    // [sa]: M, padded as acc (integer pipe)
  int4* ring;          // over acc, c1, c2 during the MMA phases
  RedcConsts consts;   // the reduction's constants in device memory

  // The block's shared memory carved for `live` rows at L, and the
  // reduction's constants.
  __device__ void init(unsigned char* smem, int L_, int live_,
                       const RedcConsts& consts_) {
    L = L_;
    live = live_;
    consts = consts_;
    sa = op_stride(L);
    st = wide_stride(L);
    sh = h_stride(L);
    nr = n_runs(L);
    ds = dig_stride(L);
    ksteps = k_pad(L) / 32;
    ring = reinterpret_cast<int4*>(smem);
    acc = reinterpret_cast<unsigned int*>(smem);
    c1 = acc + E * sa;
    c2 = c1 + E * nr;
    T = reinterpret_cast<unsigned int*>(smem + ring_region(L, E, kMxu));
    H = T + E * st;
    flag = H + E * sh;
    dig = reinterpret_cast<unsigned char*>(flag + E);
    mq = flag + E;
    mm = mq + sa;
  }

  // Zero the whole block (the operand pads and the digit padding stay
  // zero from here on); the integer pipe's constant rows loaded.
  __device__ void zero() {
    const int words = static_cast<int>(
        (dig - reinterpret_cast<unsigned char*>(acc)) / 4) +
        (kMxu ? E * ds / 4 : 2 * sa);
    for (int i = threadIdx.x; i < words; i += blockDim.x) acc[i] = 0;
    __syncthreads();
    if constexpr (!kMxu) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        mq[kPad + i] = static_cast<unsigned int>(consts.mp[i]);
        mm[kPad + i] = static_cast<unsigned int>(consts.m[i]);
      }
      __syncthreads();
    }
  }

  // Jobs of one kind over the live rows: job idx is (run idx / live, row
  // idx % live), so a warp's lanes share a run or hold adjacent ones.
  __device__ __forceinline__ int jobs(int runs) const { return runs * live; }

  // One block of kRun operand limbs i0 ... i0 + kRun - 1 into the run's
  // columns c0 ... c0 + kRun - 1: kRun^2 multiply-adds from registers,
  // with kMasked keeping only the terms i < c - i (a squaring's cross
  // terms). Then the window slides kRun limbs down for the next block.
  template <bool kMasked>
  static __device__ __forceinline__ void block(
      const unsigned int* A, const unsigned int* B, int c0, int i0,
      unsigned int (&bb)[2 * kRun - 1], unsigned long long (&s)[kRun]) {
    unsigned int a[kRun];
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      bb[m] = B[c0 - i0 - kRun + 1 + m];
      a[m] = A[i0 + m];
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      unsigned int p = 0;  // kRun products below 2^28: below 2^31
#pragma unroll
      for (int ii = 0; ii < kRun; ++ii) {
        const unsigned int t = a[ii] * bb[j - ii + kRun - 1];
        p += (!kMasked || 2 * (i0 + ii) < c0 + j) ? t : 0u;
      }
      s[j] += p;
    }
#pragma unroll
    for (int m = kRun - 2; m >= 0; --m) bb[kRun + m] = bb[m];
  }

  // Columns c0 ... c0 + kRun - 1 of A * B into s (A, B: operand rows at
  // the operand offset, their zero pads either side readable), or of A * A
  // when kSquare.
  template <bool kSquare>
  __device__ __forceinline__ void columns(
      const unsigned int* A, const unsigned int* B, int c0,
      unsigned long long (&s)[kRun]) const {
#pragma unroll
    for (int j = 0; j < kRun; ++j) s[j] = 0;
    int i0 = c0 - (L - 1) > 0 ? (c0 - (L - 1)) & ~(kRun - 1) : 0;
    int i_hi = c0 + kRun - 1 < L - 1 ? c0 + kRun - 1 : L - 1;
    if (kSquare) {
      // Cross terms i < c - i only: some column of the run has one iff
      // 2 i < c0 + kRun - 1.
      const int top = (c0 + kRun - 2) / 2;
      i_hi = i_hi < top ? i_hi : top;
    }
    // bb[m] = B[c0 - i0 - kRun + 1 + m]: column c0 + j takes a[i0 + ii]
    // times bb[j - ii + kRun - 1].
    unsigned int bb[2 * kRun - 1];
#pragma unroll
    for (int m = 0; m < kRun - 1; ++m) bb[kRun + m] = B[c0 - i0 + 1 + m];
    // Squares: blocks wholly below the diagonal (every i < c - i) run
    // unmasked; the one or two that straddle it keep i < c - i only.
    const int i_full = kSquare ? (c0 - 2 * kRun + 2) / 2 : i_hi + 1;
    for (; i0 <= i_hi && i0 < i_full; i0 += kRun) {
      block<false>(A, B, c0, i0, bb, s);
    }
    for (; i0 <= i_hi; i0 += kRun) block<kSquare>(A, B, c0, i0, bb, s);
    if (kSquare) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int c = c0 + j;
        const unsigned int d = (c & 1) ? 0u : A[c >> 1];
        s[j] = 2 * s[j] + static_cast<unsigned long long>(d * d);
      }
    }
  }

  // Run k of row e, normalised into out[0 .. kRun); c1 <- its carry-out.
  __device__ __forceinline__ void put_run(unsigned int* out,
                                          const unsigned long long (&s)[kRun],
                                          int e, int k) const {
    unsigned long long carry = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const unsigned long long v = s[j] + carry;
      out[j] = static_cast<unsigned int>(v) & kMask;
      carry = v >> 14;
    }
    c1[e * nr + k] = static_cast<unsigned int>(carry);  // < 2^26
  }

  // T <- a * b for a = acc and b = the factor in H (or acc itself when
  // square), normalised run by run; c1 <- each run's carry-out.
  template <bool kSquare>
  __device__ void mul_runs() {
    const unsigned int* bsrc = kSquare ? acc : H;
    const int sb = kSquare ? sa : sh;
    for (int idx = threadIdx.x; idx < jobs(nr); idx += blockDim.x) {
      const int k = idx / live, e = idx - k * live;
      unsigned long long s[kRun];
      columns<kSquare>(acc + e * sa + kPad, bsrc + e * sb + kPad, k * kRun, s);
      put_run(T + e * st + k * kRun, s, e, k);
    }
    __syncthreads();
  }

  // Integer pipe: T's carry bits folded into T, and T_lo copied into the
  // accumulator rows as the next operand (a is read no more); the flags
  // cleared.
  __device__ void fold_low() {
    const int n = 2 * L;
    for (int idx = threadIdx.x; idx < live * n; idx += blockDim.x) {
      const int e = idx / n, c = idx - e * n;
      const unsigned int v = limb(T + e * st, e, c);
      T[e * st + c] = v;
      if (c < L) acc[e * sa + kPad + c] = v;
    }
    if (threadIdx.x < E) flag[threadIdx.x] = 0;
    __syncthreads();
  }

  // Integer pipe: q = T_lo M' mod R, the low L columns normalised run by
  // run into H; c1 <- each run's carry-out.
  __device__ void q_runs() {
    for (int idx = threadIdx.x; idx < jobs(L / kRun); idx += blockDim.x) {
      const int k = idx / live, e = idx - k * live;
      unsigned long long s[kRun];
      columns<false>(acc + e * sa + kPad, mq + kPad, k * kRun, s);
      put_run(H + e * sh + k * kRun, s, e, k);
    }
    __syncthreads();
  }

  // Integer pipe: q into the accumulator rows, its carry bits folded (the
  // top one dropped: q mod R).
  __device__ void fold_q() {
    for (int idx = threadIdx.x; idx < live * L; idx += blockDim.x) {
      const int e = idx / L, c = idx - e * L;
      acc[e * sa + kPad + c] = limb(H + e * sh, e, c);
    }
    __syncthreads();
  }

  // Integer pipe: U = T + q M, every column normalised run by run in place
  // over T; c1 <- each run's carry-out.
  __device__ void qm_runs() {
    for (int idx = threadIdx.x; idx < jobs(nr); idx += blockDim.x) {
      const int k = idx / live, e = idx - k * live, c0 = k * kRun;
      unsigned long long s[kRun];
      columns<false>(acc + e * sa + kPad, mm + kPad, c0, s);
      unsigned int* t = T + e * st + c0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) s[j] += t[j];
      put_run(t, s, e, k);
    }
    __syncthreads();
  }

  // Columns lo[c] + hi[c - 1] of `runs` runs,
  // normalised run by run in place over lo; c1 <- each run's carry-out.
  __device__ void split_runs(unsigned int* lo, int sx, const unsigned int* hi,
                             int sy, int runs) {
    for (int idx = threadIdx.x; idx < jobs(runs); idx += blockDim.x) {
      const int k = idx / live, e = idx - k * live, c0 = k * kRun;
      unsigned int* x = lo + e * sx + c0;
      const unsigned int* y = hi + e * sy + c0;
      unsigned int v[kRun], h[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        v[j] = x[j];
        h[j] = c0 + j > 0 ? y[j - 1] : 0u;
      }
      unsigned int carry = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const unsigned int t = v[j] + h[j] + carry;  // < 2^14 + 2^20 + 2^7
        x[j] = t & kMask;
        carry = t >> 14;
      }
      c1[e * nr + k] = carry;
    }
    __syncthreads();
  }

  // Ripple the previous run's carry-out (c1) through each run of x; c2 <-
  // the carry left (0 or 1). With kFlag, runs below L set the row's flag
  // when their limbs, or the bit they pass up inside the low half, are
  // non-zero.
  template <bool kFlag>
  __device__ void ripple(unsigned int* xs, int sx, int runs) {
    for (int idx = threadIdx.x; idx < jobs(runs); idx += blockDim.x) {
      const int k = idx / live, e = idx - k * live;
      unsigned int carry = k > 0 ? c1[e * nr + k - 1] : 0u;
      unsigned int* x = xs + e * sx + k * kRun;
      unsigned int v[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) v[j] = x[j];
      unsigned int any = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const unsigned int t = v[j] + carry;
        v[j] = t & kMask;
        carry = t >> 14;
        any |= v[j];
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) x[j] = v[j];
      c2[e * nr + k] = carry;
      if (kFlag && k < L / kRun &&
          (any != 0 || (k + 1 < L / kRun && carry != 0))) {
        flag[e] = 1;
      }
    }
    __syncthreads();
  }

  // Limb c of a rippled buffer row: its value plus the bit the run below
  // passed up, when c starts a run.
  __device__ __forceinline__ unsigned int limb(const unsigned int* x, int e,
                                               int c) const {
    const int k = c / kRun;
    return x[c] + ((c == k * kRun && k > 0) ? c2[e * nr + k - 1] : 0u);
  }

  // The 2L block-order digits of limbs [0, L) of x into the digit rows:
  // the low 7 bits, then the high bits biased by -64. With kFold, the
  // carry bits are folded into x too (T keeps them for U).
  template <bool kFold>
  __device__ void digits_of(unsigned int* x, int sx, int n) {
    for (int idx = threadIdx.x; idx < live * n; idx += blockDim.x) {
      const int e = idx / n, c = idx - e * n;
      const unsigned int v = limb(x + e * sx, e, c);
      if (kFold) x[e * sx + c] = v;
      if (c < L) {
        dig[e * ds + c] = static_cast<unsigned char>(v & 0x7F);
        dig[e * ds + L + c] =
            static_cast<unsigned char>(static_cast<int>(v >> 7) - 64);
      }
    }
    __syncthreads();
  }

  // One slab's two row-block sums over the block's rows: c[b][n][i] is
  // block b, n-tile n, register i of the m16n8 C fragment (row g + 8 (i/2),
  // row 8 n + 2 t + i % 2 of the batch).
  __device__ __forceinline__ void slab(const int* wp, int s,
                                       int (&c)[2][kTiles][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int n = 0; n < kTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[b][n][i] = 0;
    const int4* ap = reinterpret_cast<const int4*>(wp) +
                     static_cast<size_t>(s) * ksteps * 64 + lane;
    // This warp's kStages ring slots of both blocks' fragments: each lane
    // copies its own 16 bytes and reads them back, so a lane's wait on
    // its own copies is the only synchronisation.
    int4* slots = ring + (threadIdx.x >> 5) * (kStages * 64) + lane;
    const unsigned char* dbase = dig + g * ds + 4 * t;
    for (int st_ = 0; st_ < kStages - 1; ++st_) {
      if (st_ < ksteps) {
        cp_async16(slots + st_ * 64, ap + st_ * 64);
        cp_async16(slots + st_ * 64 + 32, ap + st_ * 64 + 32);
      }
      cp_commit();
    }
    for (int ks = 0; ks < ksteps; ++ks) {
      const int nx = ks + kStages - 1;
      if (nx < ksteps) {
        const int slot = nx % kStages;
        cp_async16(slots + slot * 64, ap + nx * 64);
        cp_async16(slots + slot * 64 + 32, ap + nx * 64 + 32);
      }
      cp_commit();
      cp_wait<kStages - 1>();  // step ks's copies have landed
      const int cur = ks % kStages;
      const int4 a0 = slots[cur * 64], a1 = slots[cur * 64 + 32];
#pragma unroll
      for (int n = 0; n < kTiles; ++n) {
        const unsigned char* d = dbase + n * 8 * ds + ks * 32;
        const unsigned int b0 = *reinterpret_cast<const unsigned int*>(d);
        const unsigned int b1 = *reinterpret_cast<const unsigned int*>(d + 16);
        mma_s8(c[0][n], a0, b0, b1);
        mma_s8(c[1][n], a1, b0, b1);
      }
    }
  }

  // q's slots from w_mq: limb j < L of row e gets (lo + cq[j]) +
  // ((hi + cq[L + j]) << 7), stored split as its low 14 bits (H[j]) and
  // the rest (H[L + j]).
  __device__ void mma_q() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    for (int s = warp; s < q_slabs(L); s += kWarps) {
      int c[2][kTiles][4];
      slab(consts.wq, s, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = s * 16 + g + 8 * h;
        if (j >= L) continue;  // a zero padding row
        const int clo = __ldg(consts.cq + j);
        const int chi = __ldg(consts.cq + L + j);
#pragma unroll
        for (int n = 0; n < kTiles; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = n * 8 + 2 * t + x, i = 2 * h + x;
            const unsigned long long v =
                static_cast<unsigned long long>(c[0][n][i] + clo) +
                (static_cast<unsigned long long>(c[1][n][i] + chi) << 7);
            H[e * sh + j] = static_cast<unsigned int>(v) & kMask;
            H[e * sh + L + j] = static_cast<unsigned int>(v >> 14);
          }
      }
    }
    __syncthreads();
  }

  // U = T + q M from w_m: limb j < 2L of row e gets T[j] + (lo + cm[j]) +
  // ((hi + cm[2L + j]) << 7), stored split over T[j] and H[j].
  __device__ void mma_m() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    for (int s = warp; s < 2 * L / 16; s += kWarps) {
      int c[2][kTiles][4];
      slab(consts.wm, s, c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = s * 16 + g + 8 * h;
        const int clo = __ldg(consts.cm + j);
        const int chi = __ldg(consts.cm + 2 * L + j);
#pragma unroll
        for (int n = 0; n < kTiles; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = n * 8 + 2 * t + x, i = 2 * h + x;
            const unsigned long long v =
                T[e * st + j] +
                static_cast<unsigned long long>(c[0][n][i] + clo) +
                (static_cast<unsigned long long>(c[1][n][i] + chi) << 7);
            T[e * st + j] = static_cast<unsigned int>(v) & kMask;
            H[e * sh + j] = static_cast<unsigned int>(v >> 14);
          }
      }
    }
    __syncthreads();
  }

  // acc <- acc * factor * R^-1 mod M for every live row (factor: acc
  // itself when kSquare, else H as the caller left it, at the operand
  // offset with zero pads).
  template <bool kSquare>
  __device__ void product() {
    mul_runs<kSquare>();             // T = a b, runs normalised; c1
    ripple<false>(T, st, nr);        // c2
    if constexpr (kMxu) {
      digits_of<true>(T, st, 2 * L);  // T's carry bits folded; T_lo's digits
      if (threadIdx.x < E) flag[threadIdx.x] = 0;
      mma_q();                        // q slots split over H[0, 2L)
      split_runs(H, sh, H + L, sh, L / kRun);
      ripple<false>(H, sh, L / kRun);
      digits_of<false>(H, sh, L);     // digits of q mod R (top carry dropped)
      mma_m();                        // U split over T and H
      split_runs(T, st, H, sh, nr);
    } else {
      fold_low();                     // T's carry bits folded; T_lo in acc
      q_runs();                       // q's runs in H; c1
      ripple<false>(H, sh, L / kRun);
      fold_q();                       // q mod R in acc (top carry dropped)
      qm_runs();                      // U = T + q M over T; c1
    }
    ripple<true>(T, st, nr);         // c2 and the low half's flag
    // U / R: the high half, its carry bits, and one iff the low half is R;
    // the pads, which the ring overwrote, zero again.
    for (int idx = threadIdx.x; idx < live * sa; idx += blockDim.x) {
      const int e = idx / sa, i = idx - e * sa - kPad;
      acc[e * sa + kPad + i] =
          i >= 0 && i < L
              ? limb(T + e * st, e, L + i) + (i == 0 ? flag[e] : 0u)
              : 0u;
    }
    __syncthreads();
  }
};

}  // namespace phe
