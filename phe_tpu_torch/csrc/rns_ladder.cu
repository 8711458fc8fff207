// Windowed RNS Montgomery exponentiation ladder, with the exponent shared by
// the batch or one exponent per element; both base extensions of every
// product run on the int8 tensor cores with the batch as the N dimension.
//
// Replaces phe_tpu/ops/pallas_rns.py: ladder_cols (:177-244), whose kernel
// body is _ladder_kernel (:62-174), and ladder_vec_cols (:394-460), whose
// body is _ladder_vec_kernel (:265-391). The arithmetic is
// rns.rns_mont_mul's fused tau-domain Cox-Rower product (phe_tpu/ops/rns.py
// and phe_tpu_torch/ops/rns.py derive it and every bound): 28-bit channel
// products split h * 2^14 + l, steps=3 Barrett reductions, two int8 digit
// base extensions (w_ext1, w_ext2, [3 K1, 2k], K1 = k + 8) with digit-block
// recombination, and the Shenoy-Kumaresan beta from the redundant channel.
// Every residue is canonical, so this computes exactly the integers of the
// plain PyTorch ladders (phe_tpu_torch.ops.rns.ladder_plain and
// ladder_vec_plain): the two are held bit-equal.
//
// Per element: an entry product with the entry constant, a 2^w-entry
// table (tab[0] = 1, tab[1] = xd, tab[j] = tab[j-1] * xd), n_windows
// windows of w squarings and one table product, and an exit product with
// the exit constant.
//
// Design. One block runs E batch elements (E in {8, 32}, a template
// parameter that ops/cuda_rns.py's _elems picks per launch from (k, B))
// through the whole ladder. Per element, shared memory holds one residue
// row (cpad + 4 uint32, the skew putting the MMA epilogue's accesses in 32
// distinct banks) and one digit row (Kp bytes plus a 16-byte skew that
// spreads the B-fragment reads of an n-tile over all 32 banks; the skew
// holds the element's word, S row k and then beta, and one barrier of the
// ring): E (4 (cpad + 4) + Kp + 16) bytes, 99,328 at k = 304, 148,480 at
// k = 456 (the 3072-bit key's n^2) and 201,728 at k = 624 for E = 32. The
// rest is the ring (below): 32 elements fit up to k = 624, the 8192-bit
// key's p^2, where two stages take the block's last byte. Every phase of
// a product works in place on the row: the channel products overwrite
// the accumulator; sigma reads the A channels' products into the digit
// row; extension 1 reads each B channel's product and writes u~ over it
// in the same thread; extension 2 writes S row j < k over channel j, whose
// product sigma has consumed, and row k to the word (its rows past k would
// land on u~, which the tau digits, beta and the next product read, and
// nothing reads them); the last reduction rewrites the A channels. The
// channel phases between the MMAs run channel-major: a thread loads a
// channel's constants once and walks the E elements as E independent
// chains, all E loads issued before the first store. A block is nw
// consumer warps (warps_for: 10 at k = 152, 304, 456 and 624) and one
// producer warp; blocks of 32 elements run one to an SM (168 registers a
// thread at most), blocks of 8 two (80). The table lives in a
// device-memory scratch the wrapper allocates.
//
// Each base extension is C[3 K1p, E] = W[3 K1p, Kp] D[Kp, E], with K1 padded
// to K1p (16-row slabs) and 2k to Kp (32-digit K-steps) by zero rows and
// columns, which change no sum. Entries are 7-bit and every sum is below
// 2k 127^2 < 2^25, so mma.sync.m16n8k32 s8 x s8 -> s32 is exact. A warp
// owns a 16-row slab r and, for every K-step, issues three MMAs per n-tile
// of 8 elements with one B fragment: on rows r, K1 + r and 2 K1 + r (the
// c0, c1 and c2 digit blocks), so each thread's three accumulators hold
// c0, c1 and c2 of the same (row, element), and the epilogue (combine_raw,
// the q^ Barrett and u~ after extension 1; combine_raw into S after
// extension 2) runs from registers. The B fragments are the elements'
// digit rows as they lie in shared memory, two n-tiles an ldmatrix. The
// weights are packed by the host in fragment order (cuda_rns.pack_blocks),
// round by round: a lane's four A registers of one block's tile are 16
// contiguous bytes, a warp's 512, and a round's tiles at a run of K-steps
// one run of bytes.
//
// The A fragments reach the MMAs through a ring of `depth` stages in
// shared memory, each kc K-steps of a whole round (ring_shape: the most
// K-steps up to 4 of which two fit; kc = 4 at k = 152 and 304, 2 at
// k = 456, 1 at k = 624 for E = 32). The producer thread keeps the ring
// filled with one bulk copy a stage (cp.async.bulk, completing on the
// slot's full barrier), across rounds, extensions and products, and
// each warp releases a slot on its empty barrier once it has its A
// fragments in registers. Blocks run in clusters of two (cuda_rns.CLUSTER):
// each block copies half of every stage to both blocks
// (.multicast::cluster), so the matrices leave L2 once a cluster-product,
// and each warp's release goes to both blocks' barriers.
//
// Per-element exponents (ladder_vec): each element reads its own digit,
// [B, n_windows] int8 in device memory, masked to the window. The table
// factor is selected in constant time, as _ladder_vec_kernel's select
// tree (:366-385) is: every one of the 2^w rows is read and the wanted
// one kept by a mask, with no address or branch that depends on the
// digit, so the factor is exactly tab[d]. The select is the table
// product's first phase, element-major: neighbouring threads read
// neighbouring channels of one row (the reads are coalesced), and the
// thread that selects (element, channel) multiplies it into the row.
// Channel-major, holding the E factors of a channel, it spilled at E = 32
// and ran the k = 304 ladder_vec of 16,384 rows in 25.3 ms against 15.9.
//
// What bounds it on an H100, at k = 304 per element-product: 1.14 M int8
// multiply-adds (1.15 ns at the published 1,979 TOP/s), about
// cpad + 31k + 65 K1 = 30,320 int32 operations (1.8 ns at 132 x 64 lanes x
// 1.98 GHz), and the two packed matrices (2 x 3 K1p Kp = 1.17 MB), 18 KB
// an element-product at E = 32 in clusters of two. The int32 channel work
// is the floor (chip_smoke.ladder_bound). What sets the pace is how fast
// each SM takes the matrices in: the design before this one (each warp's
// __ldg stream two K-steps ahead in registers) moved 30 bytes a clock
// into each SM at k = 304 and 456 alike (1.17 MB in 22 us a block-product
// at k = 304, 2.58 MB in 49 us at k = 456; 264 and 797 ms for the r^n
// ladders of 16,384 rows). Read from shared memory with nothing copied
// in, the extensions ran 16-20 % faster; the ring's cost over that is set
// by its copies and releases, not its bytes (a third fewer bytes a stage
// changed nothing; twice as many stages of half the size ran 25 % slower
// at k = 304), hence stages of whole rounds and several K-steps. Measured
// (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py --parent, the parent
// in the same call): the r^n ladders of 16,384 rows 245.6 ms at
// k = 304 (parent 263.7-267.3) and 753.1-753.5 at k = 456 (791.2-791.7);
// the CRT half at k = 152, 49.7-50.0 (52.5-52.7); ladder_vec over 16,384
// rows 14.8-14.9 (16.0-16.1) at k = 304 and 28.5-28.6 (29.9-30.0) at
// k = 456; E = 8 at k = 624 over 512 rows 305.7 (323.7-324.0), but over
// 4,096 rows at k = 304 116.8-117.0 (112.2-113.1) and at k = 456
// 365.8-365.9 (348.6-348.9), and E = 32 at k = 624 over 4,224 rows
// 495.2-495.5 (464.5-465.5): two one-K-step stages there.
// Clusters of one ran E = 8 at k = 624 (512 rows) and k = 456 (4,096
// rows) 15 % and 62 % slower than clusters of two; clusters of four (an earlier form of the ring) the
// E = 32 ladders 24-26 % slower than two. A 16-element block
// measured no faster than an 8-element one, so there is none. The design
// before the tensor cores ran the extensions as __dp4a on the integer
// pipes, 8 elements a block: 1,954.510 ms for the k = 304 ladder.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 11;       // consumer warps a block; one more produces
constexpr int kTileBytes = 3 * 512;  // a slab's three tiles at one K-step
constexpr int kSmemLimit = 232448;
// A block's bytes with two blocks an SM: 228 KB less 1 KB for each block.
constexpr int kPairLimit = 115712;
// Blocks of a cluster (cuda_rns.CLUSTER), at either E: each copies half
// of every stage to both, so the matrices leave L2 once a
// cluster-product. Clusters of one ran the E = 8 ladders 15-62 % slower,
// clusters of four the E = 32 ones 24-26 % slower.
constexpr int kCluster = 2;

enum YSource { kYSelf, kYTable, kYPick, kYConst };

// Padded geometry; ops/cuda_rns.py's _geometry, _warps, _ring and _smem
// mirror these.
__host__ __device__ inline int k1_pad(int k) { return (k + 8 + 15) / 16 * 16; }
__host__ __device__ inline int k_pad(int k) { return (2 * k + 31) / 32 * 32; }
__host__ __device__ inline int dig_stride(int k) { return k_pad(k) + 16; }
// cpad = 2k + 8 is 8 mod 16, so cpad + 4 is 12 mod 16: the epilogue's
// lanes (8 rows by 4 element pairs) fall in 32 distinct banks.
__host__ __device__ inline int row_stride(int k) { return 2 * k + 12; }
// Consumer warps a block: the slabs spread evenly over at most kMaxWarps.
__host__ __device__ inline int warps_for(int k) {
  const int slabs = k1_pad(k) / 16;
  const int rounds = (slabs + kMaxWarps - 1) / kMaxWarps;
  return (slabs + rounds - 1) / rounds;
}
// The rows and digits of `elems` elements: 16-byte multiples. Each
// digit row's 16 bytes past Kp, which no MMA reads, hold the element's
// word (S row k, then beta) in their first 4 and one of the ring's
// barriers in their last 8.
__host__ __device__ inline int base_bytes(int k, int elems) {
  return elems * (4 * row_stride(k) + dig_stride(k));
}
// The ring: `depth` stages of `kc` K-steps of a whole round's tiles (nw
// slabs, the last round fewer), as many stages as the bytes the rows
// leave hold and the digit rows have barriers for (a full and an empty
// barrier a slot), of the most K-steps up to kMaxStageSteps of which two
// fit: fewer, larger copies keep the producer ahead. Eight-element blocks
// leave room for a second block on the SM. Where not even two one-K-step
// stages fit, depth 2 makes smem_bytes exceed the limit, and the launch
// is refused.
constexpr int kMaxStageSteps = 4;
struct RingShape {
  int kc, depth;
};
__host__ __device__ inline RingShape ring_shape(int k, int elems) {
  const int round = warps_for(k) * kTileBytes;
  const int left = (elems == 8 ? kPairLimit : kSmemLimit) - base_bytes(k, elems);
  for (int kc = kMaxStageSteps; kc >= 1; --kc) {
    const int depth = min(left / (kc * round), elems / 2);
    if (depth >= 2) return {kc, depth};
  }
  return {1, 2};
}
inline size_t smem_bytes(int k, int elems) {
  const RingShape r = ring_shape(k, elems);
  return static_cast<size_t>(base_bytes(k, elems)) +
         static_cast<size_t>(r.depth) * r.kc * warps_for(k) * kTileBytes;
}

__device__ __forceinline__ unsigned int barrett(unsigned int x,
                                                unsigned int m,
                                                unsigned int mu) {
  // x < 2^30 -> x mod m; quotient error < 8 for m >= 4099 (steps=3).
  // r < 8m; each min takes r - 2^i m where r >= 2^i m, and r otherwise
  // (below 2^i m the difference wraps past 2^32 - 2^16 > r).
  const unsigned int q = ((x >> 14) * mu) >> 14;
  unsigned int r = x - q * m;
  r = min(r, r - (m << 2));
  r = min(r, r - (m << 1));
  return min(r, r - m);
}

// c0 + 2^7 c1 + 2^14 c2, one Barrett short of canonical (< 2^28.2).
__device__ __forceinline__ unsigned int combine_raw(int c0, int c1, int c2,
                                                    unsigned int m,
                                                    unsigned int mu,
                                                    unsigned int t14) {
  const unsigned int u1 = static_cast<unsigned int>(c1);
  const unsigned int e =
      barrett(static_cast<unsigned int>(c2) + (u1 >> 7), m, mu);
  return static_cast<unsigned int>(c0) + ((u1 & 0x7F) << 7) + e * t14;
}

__device__ __forceinline__ unsigned int ld(const int64_t* p, int i) {
  return static_cast<unsigned int>(
      __ldg(reinterpret_cast<const long long*>(p) + i));
}

// c += A B for one m16n8k32 tile: A's four registers, B's two.
__device__ __forceinline__ void mma_s8(int* c, const int4& a, unsigned int b0,
                                       unsigned int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The consumer warps' barrier (id 1): the producer warp never joins it.
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One arrival on the barrier at the same offset in block `rank` of the
// cluster (this block's own rank included). Release at the default
// (block) scope: a cluster-scope release here fenced every release of a
// stage and ran the ladder up to 2.6 times slower.
__device__ __forceinline__ void bar_arrive_at(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// The producer's arrival, announcing the stage's bytes to come.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// `bytes` from global memory to the same offset of every block of the
// cluster, each block's barrier at `bar` counting them in.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  const uint16_t mask = static_cast<uint16_t>((1u << kCluster) - 1);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// The system's constant rows, each int64 [cpad], and the ladder's entry
// and exit constants.
struct Rows {
  const int64_t *m, *mu, *t14, *sig1, *sig2, *d1, *d2, *e1, *negmb, *one_dom;
  const int64_t *entry, *exitc;
};

// The ring of A stages and its walk. The packed matrices hold their
// tiles round by round (nw slabs, the last round maybe fewer: nr), each
// round K-step by K-step, each K-step its nr slabs in order
// (cuda_rns.pack_blocks). An extension's stages come in that order: round
// r, chunk of kc K-steps; stage q of the block's whole sequence (both
// extensions of every product) sits in slot q % depth, in its
// (q / depth)-th use, and is one run of the packed matrix, kc K-steps of
// nr slabs, slab i of K-step kk at (kk nr + i) kTileBytes. Each block's
// producer copies its 1 / kCluster of every run to the same offset of
// every block of the cluster; a slot's full barrier takes the producer's
// arrival and the stage's bytes, its empty barrier one arrival from each
// warp of every block of the cluster. Every warp takes every stage in
// order (one with no slab in the last round too), so no barrier's parity
// is ever asked about a phase a lap away.
struct Ring {
  int nw, kc, depth, rank;
  int slabs, ksteps, rounds, chunks;
  int stages;     // an extension's stages
  uint32_t buf;   // slot 0's stage
  uint32_t full;  // slot s's full barrier at full + s bstride, its empty
  int bstride;    // barrier depth slots further
  __device__ int round_slabs(int r) const {
    return min(nw, slabs - r * nw);
  }
  __device__ uint32_t full_bar(int s) const { return full + s * bstride; }
  __device__ uint32_t empty_bar(int s) const {
    return full + (depth + s) * bstride;
  }
};

// The producer: one thread of the block's last warp, ahead of the
// consumers by as many stages as the ring holds, across rounds,
// extensions and products alike. The slot's refill sets the pace, so all
// of a stage's arithmetic comes before the wait for the slot, and only
// the full barrier's byte count and the copy after it. (The count cannot
// come sooner: until the slot is released, the full barrier's last phase
// may still wait for its bytes.)
__device__ void produce(const Ring& rg, const unsigned char* w1,
                        const unsigned char* w2, int products) {
  const int stride = rg.kc * rg.nw * kTileBytes;
  int slot = 0;
  uint32_t phase = 0;
  for (int p = 0; p < products; ++p) {
    for (int x = 0; x < 2; ++x) {
      const unsigned char* w = x ? w2 : w1;
      for (int r = 0; r < rg.rounds; ++r) {
        const int nr = rg.round_slabs(r);
        const unsigned char* round =
            w + static_cast<size_t>(r) * rg.nw * rg.ksteps * kTileBytes;
        for (int ch = 0; ch < rg.chunks; ++ch) {
          const int ks0 = ch * rg.kc, kcc = min(rg.kc, rg.ksteps - ks0);
          const int run = kcc * nr * kTileBytes;
          const int part = run / kCluster;
          const unsigned char* src =
              round + ks0 * nr * kTileBytes + rg.rank * part;
          const uint32_t dst = rg.buf + slot * stride + rg.rank * part;
          const uint32_t full = rg.full_bar(slot);
          bar_wait(rg.empty_bar(slot), phase ^ 1);
          bar_expect(full, run);
          bulk_copy(dst, src, part, full);
          if (++slot == rg.depth) {
            slot = 0;
            phase ^= 1;
          }
        }
      }
    }
  }
}

template <int E>
struct Ladder {
  static constexpr int kTiles = E / 8;  // n-tiles of 8 elements
  int k, cpad, rs, K1, ds;  // rs: a residue row's stride
  int nt;                   // consumer threads
  const int64_t *m, *mu, *t14, *sig1, *sig2, *d1, *d2, *e1, *negmb;
  unsigned int mbinv;
  Ring rg;
  int q0;               // the block's stages consumed before this extension
  const unsigned char* ring;  // shared [depth, kc nw kTileBytes]
  unsigned int* row;    // shared [E, rs]: each element's residues
  // shared [E, ds]: columns [2k, Kp) stay zero; column Kp holds the
  // element's word (S row k, then beta), Kp + 8 a barrier of the ring.
  unsigned char* dig;
  int kp;
  __device__ unsigned int& beta(int e) const {
    return *reinterpret_cast<unsigned int*>(dig + e * ds + kp);
  }
  // kYPick: element e's table row is pick[e * pstride] mod prows (the
  // table's 2^w rows); elements at or past `live` take row 0.
  const uint8_t* pick;
  int pstride, live, prows;

  __device__ void sync() const { consumers_sync(nt); }

  // row <- row * y (one RNS Montgomery product per element), where y is
  // the row itself, the table row `trow` of each element, the row each
  // element's digit picks from its table, or a constant. Every phase
  // works in place on the one row, as set out at the head of this file.
  // The channel phases run channel-major: a thread loads a channel's
  // constants once and walks the E elements. Each loads all E of its
  // values before it stores any: the compiler cannot tell row, dig and
  // beta apart, so a store between two loads would chain the E elements
  // one after another, each waiting out the load latency.
  __device__ void montmul(YSource src, const unsigned int* tab, size_t tstride,
                          int trow, const int64_t* yconst) {
    const int tid = threadIdx.x;
    unsigned int v[E];
    if (src == kYPick) {
      // Element-major, as a warp's lanes walk one element's channels, and
      // in constant time: every one of the 2^w rows is read and the wanted
      // one kept by a mask, with no address or branch that depends on the
      // digit. Each (element, channel) is read and written by one thread.
      // The row loop is signed and bounded by prows, so the compiler can
      // count its trips: an unsigned `j <= mask` ran ladder_vec 25 % slower.
      for (int idx = tid; idx < E * cpad; idx += nt) {
        const int e = idx / cpad, c = idx - e * cpad;
        const int d = e < live ? pick[e * pstride] & (prows - 1) : 0;
        const unsigned int* col = tab + e * tstride + c;
        unsigned int f = 0;
        for (int j = 0; j < prows; ++j) {
          f |= col[static_cast<size_t>(j) * cpad] &
               (0u - static_cast<unsigned int>(j == d));
        }
        row[e * rs + c] *= f;  // < 2^28
      }
    } else {
      for (int c = tid; c < cpad; c += nt) {
        const unsigned int yc = src == kYConst ? ld(yconst, c) : 0u;
        const unsigned int* tc = tab + static_cast<size_t>(trow) * cpad + c;
        unsigned int y[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          v[e] = row[e * rs + c];
          y[e] = src == kYTable ? tc[e * tstride] : yc;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          row[e * rs + c] = v[e] * (src == kYSelf ? v[e] : y[e]);  // < 2^28
        }
      }
    }
    sync();

    // sigma over base A, as int8 digits (lo block, hi block).
    for (int i = tid; i < k; i += nt) {
      const unsigned int s1 = ld(sig1, i), s2 = ld(sig2, i);
      const unsigned int mi = ld(m, i), mui = ld(mu, i);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = row[e * rs + i];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const unsigned int s = barrett(
            (v[e] >> 14) * s2 + (v[e] & 0x3FFF) * s1, mi, mui);
        dig[e * ds + i] = static_cast<unsigned char>(s & 0x7F);
        dig[e * ds + k + i] = static_cast<unsigned char>(s >> 7);
      }
    }
    sync();

    extension<true>();  // q^, then u~ over B u r u pads (channels k + j)
    sync();

    // The stored B residues are tau: their digits feed extension 2.
    for (int j = tid; j < k; j += nt) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = row[e * rs + k + j];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dig[e * ds + j] = static_cast<unsigned char>(v[e] & 0x7F);
        dig[e * ds + k + j] = static_cast<unsigned char>(v[e] >> 7);
      }
    }
    sync();

    extension<false>();  // S over A (row i < k: channel i), row k to beta
    sync();

    // beta from the redundant channel (S row k, u~ channel 2k): row k lies
    // in another warp's slab, hence the barrier above.
    if (tid < E) {
      const unsigned int mr = ld(m, 2 * k), mur = ld(mu, 2 * k);
      const unsigned int sr = barrett(beta(tid), mr, mur);
      const unsigned int ur = row[tid * rs + 2 * k];
      beta(tid) = barrett((sr + (mr - ur)) * mbinv, mr, mur);
    }
    sync();

    unsigned int bt[E];
#pragma unroll
    for (int e = 0; e < E; ++e) bt[e] = beta(e);
    for (int i = tid; i < k; i += nt) {
      const unsigned int mi = ld(m, i), mui = ld(mu, i), nb = ld(negmb, i);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = row[e * rs + i];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        row[e * rs + i] = barrett(v[e] + bt[e] * nb, mi, mui);
      }
    }
    sync();
  }

  // One slab's three digit-block sums over the block's elements, from the
  // ring: c[b][n][i] is block b, n-tile n, register i of the m16n8 C
  // fragment (row g + 8 (i / 2), element 8 n + 2 t + i % 2 of the slab's
  // tile). The round's stage for chunk ch is q + ch, its tiles `step`
  // (the round's slabs) apart from one K-step to the next. At each K-step
  // the warp takes its A fragments (one 16-byte load a lane, a warp's 512
  // contiguous bytes each) and its B fragments (ldmatrix: two n-tiles a
  // load) and issues the MMAs; after the chunk's last A load it releases
  // the slot to every producer of the cluster. A warp with no slab in the
  // round (`has` false) waits and releases all the same: the empty
  // barrier counts every warp.
  __device__ __forceinline__ void slab(int q, int step, bool has,
                                       int (&c)[3][kTiles][4]) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int n = 0; n < kTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[b][n][i] = 0;
    const int stride = rg.kc * rg.nw * kTileBytes;
    const unsigned char* mine = ring + warp * kTileBytes + lane * 16;
    // ldmatrix rows: lanes 8 m .. 8 m + 7 address matrix m, row lane % 8:
    // n-tile 2 (m / 2) (+ the pair's first), digits 16 (m % 2) on.
    const int m8 = lane >> 3;
    const unsigned char* bsrc =
        dig + ((kTiles > 1 ? (m8 >> 1) : 0) * 8 + (lane & 7)) * ds +
        16 * (m8 & 1);
    int slot = q % rg.depth;
    uint32_t phase = (q / rg.depth) & 1;
    int kk = 0;
    for (int ks = 0; ks < rg.ksteps; ++ks) {
      if (kk == 0) bar_wait(rg.full_bar(slot), phase);
      int4 a[3];
      if (has) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          a[b] = *reinterpret_cast<const int4*>(
              mine + slot * stride + kk * step * kTileBytes + b * 512);
        }
      }
      if (++kk == rg.kc || ks + 1 == rg.ksteps) {
        __syncwarp();
        if (lane < kCluster) bar_arrive_at(rg.empty_bar(slot), lane);
        kk = 0;
        if (++slot == rg.depth) {
          slot = 0;
          phase ^= 1;
        }
      }
      if (has) {
        // All B fragments of the K-step, then its MMAs.
        unsigned int bf[kTiles][2];
#pragma unroll
        for (int n = 0; n < kTiles; n += 2) {
          unsigned int r0, r1, r2, r3;
          asm volatile(
              "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
              : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
              : "r"(shared_addr(bsrc + n * 8 * ds + ks * 32)));
          bf[n][0] = r0;
          bf[n][1] = r1;
          if (kTiles > 1) {
            bf[n + 1][0] = r2;
            bf[n + 1][1] = r3;
          }
        }
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
          mma_s8(c[0][n], a[0], bf[n][0], bf[n][1]);
          mma_s8(c[1][n], a[1], bf[n][0], bf[n][1]);
          mma_s8(c[2][n], a[2], bf[n][0], bf[n][1]);
        }
      }
    }
  }

  // Extension 1 (kFirst) or 2 over every slab: warp w takes slab
  // r nw + w of each round r, with its epilogue from the registers.
  template <bool kFirst>
  __device__ void extension() {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int r = 0; r < rg.rounds; ++r) {
      const int s = r * rg.nw + warp;
      const bool has = s < rg.slabs;
      int c[3][kTiles][4];
      slab(q0 + r * rg.chunks, rg.round_slabs(r), has, c);
      if (!has) continue;
      // Extension 1 reads the channel products of its outputs' channels,
      // all of them before its first store (see montmul), and writes u~
      // over them: each (channel, element) is this thread's alone.
      unsigned int rin[2][kTiles][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jr = s * 16 + g + 8 * h;
#pragma unroll
        for (int n = 0; n < kTiles; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            rin[h][n][x] = kFirst && jr < K1
                               ? row[(n * 8 + 2 * t + x) * rs + k + jr]
                               : 0u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jr = s * 16 + g + 8 * h;
        // Past K1 a zero padding row; past row k of S nothing reads it
        // (S row j < k lands on channel j, whose product sigma has read).
        if (jr >= (kFirst ? K1 : k + 1)) continue;
        const int ch = kFirst ? k + jr : (jr < k ? jr : k + jr);
        const unsigned int mj = ld(m, ch), muj = ld(mu, ch);
        const unsigned int t14j = ld(t14, ch);
        const unsigned int d1j = kFirst ? ld(d1, ch) : 0u;
        const unsigned int d2j = kFirst ? ld(d2, ch) : 0u;
        const unsigned int e1j = kFirst ? ld(e1, ch) : 0u;
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int e = n * 8 + 2 * t + x, i = 2 * h + x;
            const unsigned int v = combine_raw(c[0][n][i], c[1][n][i],
                                               c[2][n][i], mj, muj, t14j);
            if (kFirst) {
              const unsigned int qh = barrett(v, mj, muj);
              const unsigned int rr = rin[h][n][x];
              row[e * rs + ch] = barrett(
                  (rr >> 14) * d2j + (rr & 0x3FFF) * d1j + qh * e1j, mj, muj);
            } else if (jr < k) {
              row[e * rs + jr] = v;
            } else {
              beta(e) = v;
            }
          }
        }
      }
    }
    q0 += rg.stages;
  }
};

// kVec = false: digits is int64 [n_windows], shared by the batch.
// kVec = true: digits is int8 [B, n_windows], one schedule per element.
// Eight-element blocks run two to an SM (at most 80 registers a thread).
// Blocks run in clusters of kCluster that share each stage's copy; a
// block past the batch computes on zeros and stores nothing.
template <bool kVec, int E>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, E == 8 ? 2 : 1)
rns_ladder_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                  unsigned int* __restrict__ table, int B, int k, int cpad,
                  Rows rows, const int64_t* __restrict__ mbinv,
                  const int4* __restrict__ w1p, const int4* __restrict__ w2p,
                  const void* __restrict__ digits, int n_windows,
                  int window) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const RingShape shape = ring_shape(k, E);
  Ladder<E> ld_;
  ld_.k = k;
  ld_.cpad = cpad;
  ld_.K1 = k + 8;
  ld_.ds = dig_stride(k);
  ld_.nt = blockDim.x - 32;
  ld_.m = rows.m;
  ld_.mu = rows.mu;
  ld_.t14 = rows.t14;
  ld_.sig1 = rows.sig1;
  ld_.sig2 = rows.sig2;
  ld_.d1 = rows.d1;
  ld_.d2 = rows.d2;
  ld_.e1 = rows.e1;
  ld_.negmb = rows.negmb;
  const int64_t* one_dom = rows.one_dom;
  const int64_t* entry = rows.entry;
  const int64_t* exitc = rows.exitc;
  ld_.mbinv = static_cast<unsigned int>(mbinv[0]);
  ld_.rs = row_stride(k);
  const int rs = ld_.rs;
  // [ring: depth stages][rows][digit rows, each with its word and a
  // barrier past Kp]
  Ring& rg = ld_.rg;
  rg.nw = warps_for(k);
  ld_.ring = smem_raw;
  ld_.row = reinterpret_cast<unsigned int*>(
      smem_raw + shape.depth * shape.kc * rg.nw * kTileBytes);
  ld_.dig = reinterpret_cast<unsigned char*>(ld_.row + E * rs);
  ld_.kp = k_pad(k);

  rg.kc = shape.kc;
  rg.depth = shape.depth;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rg.rank));
  rg.slabs = k1_pad(k) / 16;
  rg.ksteps = k_pad(k) / 32;
  rg.rounds = (rg.slabs + rg.nw - 1) / rg.nw;
  rg.chunks = (rg.ksteps + rg.kc - 1) / rg.kc;
  rg.stages = rg.rounds * rg.chunks;
  rg.buf = shared_addr(smem_raw);
  rg.full = shared_addr(ld_.dig + ld_.kp + 8);
  rg.bstride = ld_.ds;
  ld_.q0 = 0;

  // The digit rows (their barrier bytes too) are zeroed before the
  // barriers are made in them.
  const int tid = threadIdx.x;
  for (int idx = tid; idx < E * ld_.ds; idx += blockDim.x) ld_.dig[idx] = 0;
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < rg.depth; ++s) {
      bar_init(rg.full_bar(s), 1);
      bar_init(rg.empty_bar(s), kCluster * rg.nw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every block's barriers stand before any block copies or arrives.
  cluster_sync();

  const int products = (1 << window) + n_windows * (window + 1);
  if (tid >= ld_.nt) {
    if (tid == ld_.nt) {
      produce(rg, reinterpret_cast<const unsigned char*>(w1p),
              reinterpret_cast<const unsigned char*>(w2p), products);
    }
  } else {
    const int nt = ld_.nt;
    const size_t e0 = static_cast<size_t>(blockIdx.x) * E;
    const size_t tstride = static_cast<size_t>(cpad) << window;  // 2^w rows
    unsigned int* tab = table + e0 * tstride;  // this block's elements
    unsigned int* row = ld_.row;
    // Elements of this block past the batch compute on zero residues and
    // are never stored.
    const int live = B - static_cast<int>(e0) < E ? B - static_cast<int>(e0)
                                                  : E;
    ld_.live = live;
    ld_.pstride = n_windows;
    ld_.prows = 1 << window;

    for (int c = tid; c < cpad; c += nt) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        row[e * rs + c] =
            e < live ? static_cast<unsigned int>(x[(e0 + e) * cpad + c]) : 0u;
      }
    }
    ld_.sync();

    // Enter the Montgomery domain; seed the table with 1 and xd.
    ld_.montmul(kYConst, nullptr, 0, 0, entry);
    for (int c = tid; c < cpad; c += nt) {
      const unsigned int one = ld(one_dom, c);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        tab[e * tstride + c] = one;
        tab[e * tstride + cpad + c] = row[e * rs + c];
      }
    }
    ld_.sync();
    for (int j = 2; j < (1 << window); ++j) {
      ld_.montmul(kYTable, tab, tstride, 1, nullptr);  // tab[j-1] * xd
      for (int c = tid; c < cpad; c += nt) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          tab[e * tstride + static_cast<size_t>(j) * cpad + c] =
              row[e * rs + c];
        }
      }
      ld_.sync();
    }

    for (int c = tid; c < cpad; c += nt) {
      const unsigned int one = ld(one_dom, c);
#pragma unroll
      for (int e = 0; e < E; ++e) row[e * rs + c] = one;
    }
    ld_.sync();
    for (int wi = 0; wi < n_windows; ++wi) {
      for (int s = 0; s < window; ++s) {
        ld_.montmul(kYSelf, nullptr, 0, 0, nullptr);
      }
      if (!kVec) {
        // Digits come from the host schedule, in [0, 2^window); the mask
        // keeps any other value inside this element's table.
        const int d =
            static_cast<int>(static_cast<const int64_t*>(digits)[wi]) &
            ((1 << window) - 1);
        ld_.montmul(kYTable, tab, tstride, d, nullptr);
      } else {
        // Each element's own digit, masked to the window, picks its factor
        // inside the product, in constant time.
        ld_.pick = static_cast<const uint8_t*>(digits) + e0 * n_windows + wi;
        ld_.montmul(kYPick, tab, tstride, 0, nullptr);
      }
    }
    // Leave the domain through the exit constant.
    ld_.montmul(kYConst, nullptr, 0, 0, exitc);

    for (int c = tid; c < cpad; c += nt) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e < live) {
          out[(e0 + e) * cpad + c] = static_cast<int64_t>(row[e * rs + c]);
        }
      }
    }
  }
  // No block leaves while its peer may still copy into it or arrive on
  // its barriers.
  cluster_sync();
}

template <bool kVec, int E>
int launch(const int64_t* x, int64_t* out, unsigned int* table, int B, int k,
           int cpad, const Rows& rows, const int64_t* mbinv, const int* w1p,
           const int* w2p, const void* digits, int n_windows, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(k, E);
  if (smem > static_cast<size_t>(kSmemLimit) || cpad != 2 * k + 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      rns_ladder_kernel<kVec, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + E - 1) / E;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  cfg.gridDim = dim3((blocks + kCluster - 1) / kCluster * kCluster);
  cfg.blockDim = dim3((warps_for(k) + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rns_ladder_kernel<kVec, E>, x, out, table, B,
                           k, cpad, rows, mbinv,
                           reinterpret_cast<const int4*>(w1p),
                           reinterpret_cast<const int4*>(w2p), digits,
                           n_windows, window);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// phe_rns_ladder_<E>: x, out: [B, cpad] int64 stored residues; table:
// uint32 scratch of ceil(ceil(B / E) / kCluster) * kCluster * E *
// 2^window * cpad words; m ... one_dom: the system's [cpad] int64 constant
// rows; entry, exitc: [cpad] int64 entry and exit constants; mbinv: [1] int64;
// w1p, w2p: the extension matrices in fragment order, stage by stage
// (cuda_rns.pack_blocks with per = the block's warps), 16-byte aligned;
// digits: [n_windows] int64.
// phe_rns_ladder_vec_<E> takes digits: [B, n_windows] int8, one MSB-first
// schedule per element. Each launches on `stream`, allocates nothing, and
// returns the launch's CUDA error.
#define PHE_RNS_LADDER_ENTRY(NAME, VEC, E, DIGIT_T)                            \
  extern "C" int NAME(                                                         \
      const int64_t* x, int64_t* out, unsigned int* table, int B, int k,      \
      int cpad, const int64_t* m, const int64_t* mu, const int64_t* t14,      \
      const int64_t* sig1, const int64_t* sig2, const int64_t* d1,            \
      const int64_t* d2, const int64_t* e1, const int64_t* neg_mb,            \
      const int64_t* one_dom, const int64_t* entry, const int64_t* exitc,     \
      const int64_t* mbinv, const int* w1p, const int* w2p,                   \
      const DIGIT_T* digits, int n_windows, int window,                       \
      cudaStream_t stream) {                                                   \
    const Rows rows{m, mu, t14, sig1, sig2, d1, d2, e1, neg_mb, one_dom,      \
                    entry, exitc};                                             \
    return launch<VEC, E>(x, out, table, B, k, cpad, rows, mbinv, w1p, w2p,   \
                          digits, n_windows, window, stream);                 \
  }

PHE_RNS_LADDER_ENTRY(phe_rns_ladder_8, false, 8, int64_t)
PHE_RNS_LADDER_ENTRY(phe_rns_ladder_32, false, 32, int64_t)
PHE_RNS_LADDER_ENTRY(phe_rns_ladder_vec_8, true, 8, int8_t)
PHE_RNS_LADDER_ENTRY(phe_rns_ladder_vec_32, true, 32, int8_t)

// Shared-memory bytes of one block of `elems` elements at k: the wrapper
// chooses E with its own copy of this formula, which the GPU tests hold
// against this one.
extern "C" int phe_rns_ladder_smem(int k, int elems) {
  return static_cast<int>(smem_bytes(k, elems));
}
