// The REDC tile: Montgomery products over 14-bit redundant limbs for E
// rows a block, both constant products of each reduction on the int8
// tensor cores (kMxu) or on the CUDA cores' integer pipe (the integer-pipe
// body, below), whichever the wrapper picks for the launch. mont_mul.cu
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
// Its jobs are balanced. A run's cost is its column height: a b and q M
// rise to the middle run and fall (a tent over 2L / kRun runs), q's low
// half rises throughout. With E = 8 or 32 row slots, each phase takes its
// runs in falling order of cost (run_at) and its threads take a round's
// jobs in snake order (thread 0 first in even rounds, last in odd ones),
// so no thread holds much more than its share and the last round holds
// the cheapest runs. With one row (E = 1) the block may be one of a
// thread-block cluster of C blocks that share the row (cluster dims from
// the launch, 1 ... 8); every block holds the whole row. Block r owns the
// runs k = r (mod C) of every phase and cuts each into slabs of g
// i-blocks (kRun operand limbs), one slab a thread a round (`plans` picks
// the odd g of fewest block-steps a thread), so the threads do equal work
// whatever the triangle's shape. Its operand rows are skewed (word y at
// y + y / 8): the lanes of a warp on one run read windows g kRun words
// apart, which for odd g fall in distinct banks. A slab's partial run is
// normalised in registers into its own slot (no atomics: on the H100 they
// cost more than the multiply-adds they gather); the owner sums its runs'
// slots (plus the diagonal of a squaring, plus T for q M), normalises
// them and stores each, with its carry-out, into every block of the
// cluster through distributed shared memory, 16 bytes a store. After one
// cluster.sync every block ripples the whole row into its own T or q from
// its own shared memory, so the folds, U's flag and / R run in every
// block. The receiving rows are double-buffered, each rewritten only
// after every block has read it. A block of the one-row tile asks for at
// least kOneRowBytes of shared memory, so that no two share an SM. The
// window table stays in device memory, one copy a block.
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
// are never read. Twelve warps a block, one block an SM. The one-row
// integer tile (E = 1) adds its four skewed operand rows, the column
// accumulator Z and its carries, the two receiving rows and their
// carries, and the prefix tables (cluster_words), and asks for
// kOneRowBytes at least.

#pragma once

#include <cooperative_groups.h>
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
constexpr int kClusterMax = 8;  // blocks a row of the one-row tile (portable)
constexpr int kSkewPad = 16;    // zero words either side of a skewed row
constexpr int kPlanHead = 4;    // a one-row plan's g, slabs, own runs
constexpr int kCand = 64;       // the slab widths a one-row plan tries (odd)
constexpr int kSlots = 3 * kThreads;  // one-row slabs a phase, at most
constexpr int kSlotWords = 9;   // a slab's kRun limbs and carry-out
// Over half the SM's shared memory: one block of the one-row tile an SM.
constexpr size_t kOneRowBytes = 116736;

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
// A skewed row of L limbs and kSkewPad zeros either side: word y at
// y + y / 8.
__host__ __device__ inline int skew_words(int L) {
  return (L + 2 * kSkewPad) / 8 * 9;
}
// The one-row integer tile's own words: four skewed rows (A, the factor,
// M', M), up to 3 words to align, two receiving rows (2L) and their
// carries (2L / kRun), the slabs' slots, the plans of its three kinds of
// phase (kPlanHead + 2L / kRun + 1 each) and their candidates' costs.
__host__ __device__ inline int cluster_words(int L) {
  return 4 * skew_words(L) + 3 + 4 * L + 2 * n_runs(L) +
         kSlots * kSlotWords + 3 * (kPlanHead + n_runs(L) + 1) + 3 * kCand;
}
// Then per row T, H and the flag; then the int8 body's digit rows, or the
// integer-pipe body's two constant rows (M', M), padded as operands, and
// with one row the cluster words.
inline size_t smem_bytes(int L, int elems, bool mxu) {
  const size_t rows = static_cast<size_t>(elems) * 4 *
                      (static_cast<size_t>(wide_stride(L)) + h_stride(L) + 1);
  const size_t bytes =
      ring_region(L, elems, mxu) + rows +
      (mxu ? static_cast<size_t>(elems) * dig_stride(L)
           : 2 * 4 * static_cast<size_t>(op_stride(L)) +
                 (elems == 1 ? 4 * static_cast<size_t>(cluster_words(L)) : 0));
  return elems == 1 && bytes < kOneRowBytes ? kOneRowBytes : bytes;
}

// The reduction's constants in device memory: for the int8 body the packed
// matrices (w_mq, w_m in fragment order) and their compensation vectors
// c_mq, c_m; for the integer-pipe body M' and M, int64 [L] limbs.
struct RedcConsts {
  const int *wq, *wm, *cq, *cm;
  const int64_t *mp, *m;
};

// A launch of `blocks` blocks of kThreads in clusters of `cluster`.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  ClusterLaunch(int blocks, int cluster, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The clusters of `cluster` blocks of `kernel` (its shared memory
// attribute set for smem) the card holds at once
// (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
inline int clusters_fit(const void* kernel, int cluster, size_t smem) {
  const ClusterLaunch launch(cluster, cluster, smem, nullptr);
  int fit = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&fit, kernel, &launch.cfg);
  return err == cudaSuccess ? fit : -static_cast<int>(err);
}

// Launch a one-row tile's kernel over `blocks` blocks in clusters of
// `cluster` (cudaLaunchKernelEx). A cluster the card cannot hold at all
// (clusters_fit 0) is refused with cudaErrorLaunchOutOfResources:
// nothing falls back to another shape.
template <typename... Exp, typename... Act>
inline cudaError_t launch_cluster(void (*kernel)(Exp...), int blocks,
                                  int cluster, size_t smem,
                                  cudaStream_t stream, Act... args) {
  const int fit =
      clusters_fit(reinterpret_cast<const void*>(kernel), cluster, smem);
  if (fit < 0) return static_cast<cudaError_t>(-fit);
  if (fit == 0) return cudaErrorLaunchOutOfResources;
  const ClusterLaunch launch(blocks, cluster, smem, stream);
  return cudaLaunchKernelEx(&launch.cfg, kernel, args...);
}

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
// E = 1: the one-row integer tile, one block of a cluster (integer pipe
// only).
template <int E, bool kMxu>
struct RedcTile {
  static_assert(E != 1 || !kMxu, "the one-row tile is integer-pipe only");
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
  // The one-row tile (E = 1): the block's rank in its cluster of C.
  int rank, C, ph;     // ph: the receiving row of the next product's a b
  unsigned int *As, *Bs, *Qs, *Ms;  // skewed rows: A, the factor, M', M
  // Two of each, buffer p at + p * 2L (rows) or + p * nr (carries):
  unsigned int* zr0;   // [2L]: every run as its owner sent it (16-byte
                       // aligned)
  unsigned int* c1r0;  // [nr]: every run's carry-out as its owner sent it
  unsigned int* slot;  // [kSlots, kSlotWords]: the slabs' partial runs
  int* plan;           // [3, kPlanHead + nr + 1], then [3, kCand]

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
    if constexpr (E == 1) {
      namespace cg = cooperative_groups;
      cg::cluster_group cl = cg::this_cluster();
      rank = static_cast<int>(cl.block_rank());
      C = static_cast<int>(cl.num_blocks());
      ph = 0;
      const int sk = skew_words(L);
      As = mm + sa;
      Bs = As + sk;
      Qs = Bs + sk;
      Ms = Qs + sk;
      zr0 = reinterpret_cast<unsigned int*>(
          (reinterpret_cast<uintptr_t>(Ms + sk) + 15) & ~uintptr_t{15});
      c1r0 = zr0 + 4 * L;
      slot = c1r0 + 2 * nr;
      plan = reinterpret_cast<int*>(slot + kSlots * kSlotWords);
    }
  }

  // Zero the whole block (the operand pads and the digit padding stay
  // zero from here on); the integer pipe's constant rows loaded.
  __device__ void zero() {
    const int words = static_cast<int>(
        (dig - reinterpret_cast<unsigned char*>(acc)) / 4) +
        (kMxu ? E * ds / 4 : 2 * sa + (E == 1 ? cluster_words(L) : 0));
    for (int i = threadIdx.x; i < words; i += blockDim.x) acc[i] = 0;
    __syncthreads();
    if constexpr (!kMxu) {
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        mq[kPad + i] = static_cast<unsigned int>(consts.mp[i]);
        mm[kPad + i] = static_cast<unsigned int>(consts.m[i]);
        if constexpr (E == 1) {
          Qs[skew(kSkewPad + i)] = static_cast<unsigned int>(consts.mp[i]);
          Ms[skew(kSkewPad + i)] = static_cast<unsigned int>(consts.m[i]);
        }
      }
      if constexpr (E == 1) plans();
      __syncthreads();
    }
  }

  // The one-row tile's skewed rows: word y at y + y / 8.
  static __device__ __forceinline__ int skew(int y) { return y + (y >> 3); }

  // Integer pipe: the run at position p of `runs` runs in falling order of
  // cost. A full product's column heights rise to its middle runs and fall
  // (tent: runs = 2L / kRun, the two middle runs first, then outwards in
  // pairs), q's low half rises throughout (its top run first).
  static __device__ __forceinline__ int run_at(int p, int runs, bool tent) {
    if (!tent) return runs - 1 - p;
    const int v = p >> 1, h = runs >> 1;
    return (p & 1) ? h + v : h - 1 - v;
  }

  // Integer pipe, E = 8 or 32: f(k, e) for every run k of `runs` and live
  // row e, runs in falling order of cost (row fastest, so a warp's lanes
  // share a run or hold runs of nearly equal cost), the threads taking a
  // round's jobs in snake order: thread t the t-th in even rounds and the
  // (kThreads - 1 - t)-th in odd ones.
  template <class F>
  __device__ __forceinline__ void balanced(int runs, bool tent, F f) const {
    const int n = jobs(runs), t = threadIdx.x;
    for (int r = 0;; ++r) {
      const int idx = r * kThreads + ((r & 1) ? kThreads - 1 - t : t);
      if (idx >= n) break;  // a later round starts past n too
      const int p = idx / live;
      f(run_at(p, runs, tent), idx - p * live);
    }
  }

  // The one-row tile's phases: kind 0 a b or q M, 1 a a, 2 q (L / kRun
  // runs). Run k's i-blocks (kRun operand limbs each) are [lo, lo + n),
  // as columns() walks them.
  __device__ __forceinline__ int kind_runs(int kind) const {
    return kind == 2 ? L / kRun : nr;
  }
  __device__ __forceinline__ void span(int kind, int k, int& lo,
                                       int& n) const {
    const int nl = L / kRun;
    int hi = k < nl - 1 ? k : nl - 1;
    if (kind == 1 && (k >> 1) < hi) hi = k >> 1;  // i < c - i
    lo = k < nl ? 0 : k - nl;
    n = hi - lo + 1;
  }
  // The block's own runs of a kind: k = rank + C m, m < own(kind).
  __device__ __forceinline__ int own(int kind) const {
    const int runs = kind_runs(kind);
    return rank < runs ? (runs - 1 - rank) / C + 1 : 0;
  }
  __device__ __forceinline__ unsigned int* Zr(int p) const {
    return zr0 + p * 2 * L;
  }
  __device__ __forceinline__ unsigned int* c1r(int p) const {
    return c1r0 + p * nr;
  }
  __device__ __forceinline__ int* plan_of(int kind) const {
    return plan + kind * (kPlanHead + nr + 1);
  }

  // The plans: for each kind, the odd slab width g in 1, 3 ... 2 kCand - 1
  // whose slabs (ceil(n / g) for an own run of n i-blocks, at most kSlots)
  // take the fewest block-steps a thread (ceil(slabs / kThreads) g; the
  // widest of equals), the slabs, the own runs, and each own run's first
  // slab. (An odd g puts the lanes of a warp on one run, g i-blocks apart,
  // in distinct banks of the skewed rows.)
  __device__ void plans() {
    int* cost = plan + 3 * (kPlanHead + nr + 1);
    for (int idx = threadIdx.x; idx < 3 * kCand; idx += kThreads) {
      const int kind = idx / kCand, g = 2 * (idx - kind * kCand) + 1;
      int total = 0;
      for (int m = 0; m < own(kind); ++m) {
        int lo, n;
        span(kind, rank + C * m, lo, n);
        total += (n + g - 1) / g;
      }
      cost[idx] = total > kSlots ? 0x7fffffff
                                 : (total + kThreads - 1) / kThreads * g;
    }
    __syncthreads();
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (w >= 3) return;
    int* pl = plan_of(w);
    int best = 0;
    for (int c = 1; c < kCand; ++c) {
      if (cost[w * kCand + c] <= cost[w * kCand + best]) best = c;
    }
    const int g = 2 * best + 1;
    const int n_own = own(w);
    int sum = 0;
    for (int base = 0; base < n_own; base += 32) {
      const int m = base + lane;
      int lo, n = 0;
      if (m < n_own) span(w, rank + C * m, lo, n);
      n = (n + g - 1) / g;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, n, d);
        if (lane >= d) n += x;
      }
      if (m < n_own) pl[kPlanHead + m + 1] = sum + n;
      sum += __shfl_sync(0xffffffffu, n, 31);
    }
    if (lane == 0) {
      pl[0] = g;
      pl[1] = sum;
      pl[2] = n_own;
      pl[kPlanHead] = 0;
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
    macs<kMasked>(a, c0, i0, bb, s);
  }

  // A block's kRun^2 multiply-adds from registers, then the window slides.
  template <bool kMasked>
  static __device__ __forceinline__ void macs(
      const unsigned int (&a)[kRun], int c0, int i0,
      unsigned int (&bb)[2 * kRun - 1], unsigned long long (&s)[kRun]) {
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

  // block() from the one-row tile's skewed rows. A's kRun words from i0
  // start at a multiple of 8; of B's window, the words d = 1 - kRun ... 0
  // from c0 - i0 (a multiple of 8) sit at skew(y0) + d - 1 for d < 0.
  template <bool kMasked>
  static __device__ __forceinline__ void sblock(
      const unsigned int* As, const unsigned int* Bs, int c0, int i0,
      unsigned int (&bb)[2 * kRun - 1], unsigned long long (&s)[kRun]) {
    const unsigned int* ap = As + skew(kSkewPad + i0);
    const unsigned int* bp = Bs + skew(kSkewPad + c0 - i0);
    unsigned int a[kRun];
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      bb[m] = m < kRun - 1 ? bp[m - kRun] : bp[0];
      a[m] = ap[m];
    }
    macs<kMasked>(a, c0, i0, bb, s);
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
    if constexpr (kMxu) {
      for (; i0 <= i_hi && i0 < i_full; i0 += kRun) {
        block<false>(A, B, c0, i0, bb, s);
      }
      for (; i0 <= i_hi; i0 += kRun) block<kSquare>(A, B, c0, i0, bb, s);
    } else {
      // Unrolled by two, the window's slide becomes register renaming
      // (faster here in turns; the int8 body ran slower so, and keeps
      // its loops).
#pragma unroll 2
      for (; i0 <= i_hi && i0 < i_full; i0 += kRun) {
        block<false>(A, B, c0, i0, bb, s);
      }
#pragma unroll 2
      for (; i0 <= i_hi; i0 += kRun) block<kSquare>(A, B, c0, i0, bb, s);
    }
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
    auto job = [&](int k, int e) {
      unsigned long long s[kRun];
      columns<kSquare>(acc + e * sa + kPad, bsrc + e * sb + kPad, k * kRun, s);
      put_run(T + e * st + k * kRun, s, e, k);
    };
    if constexpr (kMxu) {
      for (int idx = threadIdx.x; idx < jobs(nr); idx += blockDim.x) {
        const int k = idx / live;
        job(k, idx - k * live);
      }
    } else {
      balanced(nr, true, job);
    }
    __syncthreads();
  }

  // Integer pipe: T's carry bits folded into T, and T_lo copied into the
  // accumulator rows as the next operand (a is read no more); the flags
  // cleared.
  __device__ void fold_low() {
    const int n = 2 * L;
    // Element (e, c) of the flat index, stepped by kThreads without a
    // division.
    int e = threadIdx.x / n, c = threadIdx.x - e * n;
    while (e < live) {
      const unsigned int v = limb(T + e * st, e, c);
      T[e * st + c] = v;
      if (c < L) {
        acc[e * sa + kPad + c] = v;
        if constexpr (E == 1) As[skew(kSkewPad + c)] = v;
      }
      for (c += kThreads; c >= n; c -= n) ++e;
    }
    if (threadIdx.x < E) flag[threadIdx.x] = 0;
    __syncthreads();
  }

  // Integer pipe: q = T_lo M' mod R, the low L columns normalised run by
  // run into H; c1 <- each run's carry-out.
  __device__ void q_runs() {
    balanced(L / kRun, false, [&](int k, int e) {
      unsigned long long s[kRun];
      columns<false>(acc + e * sa + kPad, mq + kPad, k * kRun, s);
      put_run(H + e * sh + k * kRun, s, e, k);
    });
    __syncthreads();
  }

  // Integer pipe: q into the accumulator rows, its carry bits folded (the
  // top one dropped: q mod R).
  __device__ void fold_q() {
    int e = threadIdx.x / L, c = threadIdx.x - e * L;
    while (e < live) {
      const unsigned int v = limb(H + e * sh, e, c);
      acc[e * sa + kPad + c] = v;
      if constexpr (E == 1) As[skew(kSkewPad + c)] = v;
      for (c += kThreads; c >= L; c -= L) ++e;
    }
    __syncthreads();
  }

  // Integer pipe: U = T + q M, every column normalised run by run in place
  // over T; c1 <- each run's carry-out.
  __device__ void qm_runs() {
    balanced(nr, true, [&](int k, int e) {
      const int c0 = k * kRun;
      unsigned long long s[kRun];
      columns<false>(acc + e * sa + kPad, mm + kPad, c0, s);
      unsigned int* t = T + e * st + c0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) s[j] += t[j];
      put_run(t, s, e, k);
    });
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

  // The one-row tile: columns c0 ... c0 + kRun - 1 of As * Bs (skewed)
  // over the nb i-blocks from b0 (As * As when kSquare: the cross terms
  // i < c - i only, doubled; the owner adds the diagonal), as columns()
  // sums them.
  template <bool kSquare>
  __device__ __forceinline__ void piece(const unsigned int* As,
                                        const unsigned int* Bs, int c0, int b0,
                                        int nb,
                                        unsigned long long (&s)[kRun]) const {
#pragma unroll
    for (int j = 0; j < kRun; ++j) s[j] = 0;
    int i0 = b0 * kRun;
    const int end = (b0 + nb) * kRun;
    unsigned int bb[2 * kRun - 1];
    const unsigned int* bp = Bs + skew(kSkewPad + c0 - i0);
#pragma unroll
    for (int m = 0; m < kRun - 1; ++m) bb[kRun + m] = bp[1 + m];
    const int i_full = kSquare ? (c0 - 2 * kRun + 2) / 2 : end;
#pragma unroll 2
    for (; i0 < end && i0 < i_full; i0 += kRun) {
      sblock<false>(As, Bs, c0, i0, bb, s);
    }
#pragma unroll 2
    for (; i0 < end; i0 += kRun) sblock<kSquare>(As, Bs, c0, i0, bb, s);
    if (kSquare) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) s[j] <<= 1;
    }
  }

  // The one-row tile, one phase's slabs: own run m of `kind` (k = rank +
  // C m) cut into slabs of g i-blocks, slab j of it at index pre[m] + j,
  // one slab a thread a round; each slab's columns normalised into kRun
  // limbs and a carry-out in its own slot (no two threads share one).
  template <bool kSquare>
  __device__ void slabs(int kind, const unsigned int* As,
                        const unsigned int* Bs) {
    const int* pl = plan_of(kind);
    const int g = pl[0], total = pl[1], n_own = pl[2];
    const int* pre = pl + kPlanHead;
    for (int q = threadIdx.x; q < total; q += kThreads) {
      int m = 0, top = n_own - 1;  // the own run whose slabs hold q
      while (m < top) {
        const int mid = (m + top + 1) >> 1;
        if (pre[mid] <= q) m = mid; else top = mid - 1;
      }
      const int k = rank + C * m, j = q - pre[m];
      int lo, n;
      span(kind, k, lo, n);
      unsigned long long s[kRun];
      piece<kSquare>(As, Bs, k * kRun, lo + j * g,
                     n - j * g < g ? n - j * g : g, s);
      unsigned int* out = slot + q * kSlotWords;
      unsigned long long carry = 0;
#pragma unroll
      for (int c = 0; c < kRun; ++c) {
        const unsigned long long v = s[c] + carry;
        out[c] = static_cast<unsigned int>(v) & kMask;
        carry = v >> 14;
      }
      out[kRun] = static_cast<unsigned int>(carry);  // < 2^25
    }
    __syncthreads();
  }

  // The one-row tile: each own run of `kind` summed over its slabs' slots
  // (one thread a run and word, into the run's first slot; then plus the
  // diagonal a_i^2 of a squaring at even columns, plus T for q M: kAddT),
  // normalised into receiving row p, its carry-out (and its slabs'
  // carries) into c1r(p); then every own run stored into the other
  // blocks' receiving row p through distributed shared memory, 16 bytes
  // a store.
  template <bool kSquare, bool kAddT>
  __device__ void settle(int kind, int p) {
    const int* pl = plan_of(kind);
    const int n_own = pl[2];
    const int* pre = pl + kPlanHead;
    for (int idx = threadIdx.x; idx < n_own * kSlotWords; idx += kThreads) {
      const int m = idx / kSlotWords, c = idx - m * kSlotWords;
      unsigned int* first = slot + pre[m] * kSlotWords + c;
      unsigned int sum = *first;  // kRun limbs < 2^22, carries < 2^26
      for (int q = pre[m] + 1; q < pre[m + 1]; ++q) {
        sum += slot[q * kSlotWords + c];
      }
      *first = sum;
    }
    __syncthreads();
    for (int m = threadIdx.x; m < n_own; m += kThreads) {
      const int k = rank + C * m, c0 = k * kRun;
      const unsigned int* sum = slot + pre[m] * kSlotWords;
      unsigned long long carry = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int c = c0 + j;
        unsigned long long x = static_cast<unsigned long long>(sum[j]) + carry;
        if (kSquare && !(c & 1)) {
          const unsigned int d = acc[kPad + (c >> 1)];
          x += static_cast<unsigned long long>(d * d);
        }
        if (kAddT) x += T[c];
        Zr(p)[c] = static_cast<unsigned int>(x) & kMask;
        carry = x >> 14;
      }
      c1r(p)[k] = static_cast<unsigned int>(carry) + sum[kRun];  // < 2^27
    }
    __syncthreads();
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    for (int idx = threadIdx.x; idx < n_own * (C - 1); idx += kThreads) {
      const int m = idx / (C - 1), d = idx - m * (C - 1);
      const unsigned int to = static_cast<unsigned int>(d < rank ? d : d + 1);
      const int k = rank + C * m;
      const uint4* from = reinterpret_cast<const uint4*>(Zr(p) + k * kRun);
      uint4* zr = reinterpret_cast<uint4*>(
          cl.map_shared_rank(Zr(p), to) + k * kRun);
      zr[0] = from[0];
      zr[1] = from[1];
      *cl.map_shared_rank(c1r(p) + k, to) = c1r(p)[k];
    }
  }

  // The one-row tile, after the cluster barrier: every run of the phase
  // from receiving row p and the carry below it, rippled into x (and c2,
  // and with kFlag the low half's flag, as ripple).
  template <bool kFlag>
  __device__ void receive(unsigned int* x, int runs, int p) {
    for (int k = threadIdx.x; k < runs; k += kThreads) {
      unsigned int carry = k > 0 ? c1r(p)[k - 1] : 0u;
      unsigned int v[kRun];
#pragma unroll
      for (int j = 0; j < kRun; ++j) v[j] = Zr(p)[k * kRun + j];
      unsigned int any = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const unsigned int t = v[j] + carry;
        v[j] = t & kMask;
        carry = t >> 14;
        any |= v[j];
      }
#pragma unroll
      for (int j = 0; j < kRun; ++j) x[k * kRun + j] = v[j];
      c2[k] = carry;
      if (kFlag && k < L / kRun &&
          (any != 0 || (k + 1 < L / kRun && carry != 0))) {
        flag[0] = 1;
      }
    }
    __syncthreads();
  }

  // The one-row tile: the product's operands into the skewed rows (a, and
  // the factor unless kSquare).
  template <bool kSquare>
  __device__ void stage() {
    for (int i = threadIdx.x; i < L; i += kThreads) {
      As[skew(kSkewPad + i)] = acc[kPad + i];
      if (!kSquare) Bs[skew(kSkewPad + i)] = H[kPad + i];
    }
    __syncthreads();
  }

  // The one-row tile, one phase: the slabs, the owners' settle into every
  // block, a cluster barrier, the receive into x.
  template <bool kSquare, bool kAddT, bool kFlag>
  __device__ void cluster_phase(int kind, const unsigned int* Bs,
                                unsigned int* x, int p) {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    slabs<kSquare>(kind, As, Bs);
    settle<kSquare, kAddT>(kind, p);
    cl.sync();
    receive<kFlag>(x, kind_runs(kind), p);
  }

  // The one-row tile's product: its three phases, and between them the
  // block-local folds of the integer-pipe body (which also fill the
  // skewed A row).
  template <bool kSquare>
  __device__ void cluster_product() {
    const int p = ph;
    ph ^= 1;
    stage<kSquare>();
    cluster_phase<kSquare, false, false>(kSquare ? 1 : 0,
                                         kSquare ? As : Bs, T, p);  // a b
    fold_low();                                     // T folded; T_lo in As
    cluster_phase<false, false, false>(2, Qs, H, p ^ 1);  // q
    fold_q();                                       // q mod R in As
    cluster_phase<false, true, true>(0, Ms, T, p);  // U = T + q M; flag
  }

  // acc <- acc * factor * R^-1 mod M for every live row (factor: acc
  // itself when kSquare, else H as the caller left it, at the operand
  // offset with zero pads).
  template <bool kSquare>
  __device__ void product() {
    if constexpr (E == 1) {
      cluster_product<kSquare>();
    } else {
      block_product<kSquare>();
    }
    u_over_r();
  }

  // The product of E = 8 or 32 row slots, up to U's carries and flag.
  template <bool kSquare>
  __device__ void block_product() {
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
  }

  // U / R: the high half, its carry bits, and one iff the low half is R;
  // the pads, which the ring overwrote, zero again.
  __device__ void u_over_r() {
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
