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
// distinct banks), one digit row (Kp bytes plus a 16-byte skew that
// spreads the fragment reads of the eight elements of an n-tile over all
// 32 banks) and one word, S row k and then beta: E (4 (cpad + 4) + Kp +
// 20) bytes. At E = 32 that is 99,456 at k = 304, 148,608 at k = 456 (the
// 3072-bit key's n^2) and 201,856 at k = 624, so 32 elements fit at every
// k the channel supply allows (up to 664). Every phase of a product works
// in place on the row: the channel products overwrite the accumulator;
// sigma reads the A channels' products into the digit row; extension 1
// reads each B channel's product and writes u~ over it in the same
// thread; extension 2 writes S row j < k over channel j, whose product
// sigma has consumed, and row k to the word (its rows past k would land on
// u~, which the tau digits, beta and the next product read, and nothing
// reads them); the last reduction rewrites the A channels. The channel
// phases between the MMAs run channel-major: a thread loads a channel's
// constants once and walks the E elements as E independent chains, all E
// loads issued before the first store. Blocks of 32 elements run one to an
// SM (168 registers a thread at most); blocks of 8 two (80). The table
// lives in a device-memory scratch the wrapper allocates
// ([ceil(B/E) E, 2^w, cpad] uint32).
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
// extension 2) runs from registers. The B fragment is the element's digit
// row as it lies in shared memory (two 32-bit loads a lane). The weights are
// packed by the host in fragment order (cuda_rns.pack_blocks): a
// lane's four A registers of one block's tile are 16 contiguous bytes, a
// warp's 512, read with coalesced 16-byte __ldg loads kept kStages - 1
// K-steps ahead of the MMAs in registers (no shared-memory ring).
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
// 1.98 GHz), and the two packed matrices (2 x 3 K1p Kp = 1.17 MB) streamed
// from L2 once per block-product: 36 KB an element-product at E = 32. The
// int32 channel work is the floor (chip_smoke.ladder_bound). Measured
// (NVIDIA H100 80GB HBM3, 700.00 W): 6.7 ns an element-product at E = 32
// and 11.0 at E = 8 (one_product_split), the stream at 5.4 and 13.4
// TB/s; 264 ms for the k = 304 ladder of 16,384 rows. At k = 456 an
// element-product streams 81 KB at E = 32 and 323 KB at E = 8: 13.1 ns
// at E = 32 (6.2 TB/s) against 22.9 at E = 8 (14.1 TB/s), and the r^n
// ladder of 16,384 rows (exponent n, window 5) takes 797 ms at E = 32
// and 1,395 ms at E = 8. The layout before this one kept two residue rows
// an element, so k = 456 fitted only E = 8 (24.0 ns, 1,519-1,576 ms).
// SM clock stamps around each phase of one product put 81 % of its
// cycles at E = 32 and k = 304 in the two extensions: per K-step a warp's
// three 16-byte fragment loads, eight B-fragment loads and twelve MMAs,
// about 420 cycles with one block on the SM. The channel phases take the
// other 19 %. A 16-element block measured no faster than an 8-element
// one, so there is none. The design before the tensor cores ran the
// extensions as __dp4a on the integer pipes, 8 elements a block:
// 1,954.510 ms for the k = 304 ladder (NVIDIA H100 80GB HBM3, 700.00 W).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 12;  // warps a block; 168 registers a thread
constexpr int kStages = 3;     // K-steps of A fragments held in registers
constexpr int kSmemLimit = 232448;

enum YSource { kYSelf, kYTable, kYPick, kYConst };

// Padded geometry; ops/cuda_rns.py's _geometry and _smem mirror these.
__host__ __device__ inline int k1_pad(int k) { return (k + 8 + 15) / 16 * 16; }
__host__ __device__ inline int k_pad(int k) { return (2 * k + 31) / 32 * 32; }
__host__ __device__ inline int dig_stride(int k) { return k_pad(k) + 16; }
// cpad = 2k + 8 is 8 mod 16, so cpad + 4 is 12 mod 16: the epilogue's
// lanes (8 rows by 4 element pairs) fall in 32 distinct banks.
__host__ __device__ inline int row_stride(int k) { return 2 * k + 12; }
inline size_t smem_bytes(int k, int elems) {
  return static_cast<size_t>(elems) *
         (4 * row_stride(k) + dig_stride(k) + sizeof(unsigned int));
}
// Warps a block: the slabs spread evenly over at most kMaxWarps warps.
inline int warps_for(int k) {
  const int slabs = k1_pad(k) / 16;
  const int rounds = (slabs + kMaxWarps - 1) / kMaxWarps;
  return (slabs + rounds - 1) / rounds;
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

// The system's constant rows, each int64 [cpad], and the ladder's entry
// and exit constants.
struct Rows {
  const int64_t *m, *mu, *t14, *sig1, *sig2, *d1, *d2, *e1, *negmb, *one_dom;
  const int64_t *entry, *exitc;
};

template <int E>
struct Ladder {
  static constexpr int kTiles = E / 8;  // n-tiles of 8 elements
  int k, cpad, rs, K1, slabs, ksteps, ds;  // rs: a residue row's stride
  const int64_t *m, *mu, *t14, *sig1, *sig2, *d1, *d2, *e1, *negmb;
  unsigned int mbinv;
  const int4* w1p;  // [slabs, ksteps, 3, 32] fragment-ordered int8 tiles
  const int4* w2p;
  unsigned int* row;    // shared [E, rs]: each element's residues
  unsigned char* dig;   // shared [E, ds]; columns [2k, ds) stay zero
  unsigned int* beta;   // shared [E]: S row k, then beta
  // kYPick: element e's table row is pick[e * pstride] mod prows (the
  // table's 2^w rows); elements at or past `live` take row 0.
  const uint8_t* pick;
  int pstride, live, prows;

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
    const int tid = threadIdx.x, nt = blockDim.x;
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
    __syncthreads();

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
    __syncthreads();

    extension<true>(w1p);  // q^, then u~ over B u r u pads (channels k + j)
    __syncthreads();

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
    __syncthreads();

    extension<false>(w2p);  // S over A (row i < k: channel i), row k to beta
    __syncthreads();

    // beta from the redundant channel (S row k, u~ channel 2k): row k lies
    // in another warp's slab, hence the barrier above.
    if (tid < E) {
      const unsigned int mr = ld(m, 2 * k), mur = ld(mu, 2 * k);
      const unsigned int sr = barrett(beta[tid], mr, mur);
      const unsigned int ur = row[tid * rs + 2 * k];
      beta[tid] = barrett((sr + (mr - ur)) * mbinv, mr, mur);
    }
    __syncthreads();

    unsigned int bt[E];
#pragma unroll
    for (int e = 0; e < E; ++e) bt[e] = beta[e];
    for (int i = tid; i < k; i += nt) {
      const unsigned int mi = ld(m, i), mui = ld(mu, i), nb = ld(negmb, i);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = row[e * rs + i];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        row[e * rs + i] = barrett(v[e] + bt[e] * nb, mi, mui);
      }
    }
    __syncthreads();
  }

  // One slab's three digit-block sums over the block's elements:
  // c[b][n][i] is block b, n-tile n, register i of the m16n8 C fragment
  // (row g + 8 (i / 2), element 8 n + 2 t + i % 2 of the slab's tile).
  __device__ __forceinline__ void slab(const int4* wp, int s,
                                       int (&c)[3][kTiles][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int n = 0; n < kTiles; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[b][n][i] = 0;
    const int4* ap = wp + static_cast<size_t>(s) * ksteps * 96 + lane;
    const unsigned char* dbase = dig + g * ds + 4 * t;
    int4 a[kStages][3];
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < ksteps) {
#pragma unroll
        for (int b = 0; b < 3; ++b) a[st][b] = __ldg(ap + st * 96 + b * 32);
      }
    }
    for (int ks0 = 0; ks0 < ksteps; ks0 += kStages) {
#pragma unroll
      for (int st = 0; st < kStages; ++st) {
        const int ks = ks0 + st;
        if (ks < ksteps) {
          const int nx = ks + kStages - 1;
          if (nx < ksteps) {
#pragma unroll
            for (int b = 0; b < 3; ++b) {
              a[(st + kStages - 1) % kStages][b] =
                  __ldg(ap + nx * 96 + b * 32);
            }
          }
#pragma unroll
          for (int n = 0; n < kTiles; ++n) {
            const unsigned char* d = dbase + n * 8 * ds + ks * 32;
            const unsigned int b0 = *reinterpret_cast<const unsigned int*>(d);
            const unsigned int b1 =
                *reinterpret_cast<const unsigned int*>(d + 16);
            mma_s8(c[0][n], a[st][0], b0, b1);
            mma_s8(c[1][n], a[st][1], b0, b1);
            mma_s8(c[2][n], a[st][2], b0, b1);
          }
        }
      }
    }
  }

  // Extension 1 (kFirst) or 2 over every slab, each warp taking slabs
  // warp, warp + warps, ..., with its epilogue from the registers.
  template <bool kFirst>
  __device__ void extension(const int4* wp) {
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int s = warp; s < slabs; s += nw) {
      int c[3][kTiles][4];
      slab(wp, s, c);
      // Extension 1 reads the channel products of its outputs' channels,
      // all of them before its first store (see montmul), and writes u~
      // over them: each (channel, element) is this thread's alone.
      unsigned int rin[2][kTiles][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = s * 16 + g + 8 * h;
#pragma unroll
        for (int n = 0; n < kTiles; ++n)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            rin[h][n][x] = kFirst && j < K1
                               ? row[(n * 8 + 2 * t + x) * rs + k + j]
                               : 0u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = s * 16 + g + 8 * h;
        // Past K1 a zero padding row; past row k of S nothing reads it
        // (S row j < k lands on channel j, whose product sigma has read).
        if (j >= (kFirst ? K1 : k + 1)) continue;
        const int ch = kFirst ? k + j : (j < k ? j : k + j);
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
              const unsigned int r = rin[h][n][x];
              row[e * rs + ch] = barrett(
                  (r >> 14) * d2j + (r & 0x3FFF) * d1j + qh * e1j, mj, muj);
            } else if (j < k) {
              row[e * rs + j] = v;
            } else {
              beta[e] = v;
            }
          }
        }
      }
    }
  }
};

// kVec = false: digits is int64 [n_windows], shared by the batch.
// kVec = true: digits is int8 [B, n_windows], one schedule per element.
// Eight-element blocks run two to an SM (at most 80 registers a thread).
template <bool kVec, int E>
__global__ void __launch_bounds__(kMaxWarps * 32, E == 8 ? 2 : 1)
rns_ladder_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                  unsigned int* __restrict__ table, int B, int k, int cpad,
                  Rows rows, const int64_t* __restrict__ mbinv,
                  const int4* __restrict__ w1p, const int4* __restrict__ w2p,
                  const void* __restrict__ digits, int n_windows,
                  int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ladder<E> ld_;
  ld_.k = k;
  ld_.cpad = cpad;
  ld_.K1 = k + 8;
  ld_.slabs = k1_pad(k) / 16;
  ld_.ksteps = k_pad(k) / 32;
  ld_.ds = dig_stride(k);
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
  ld_.w1p = w1p;
  ld_.w2p = w2p;
  ld_.rs = row_stride(k);
  const int rs = ld_.rs;
  ld_.row = reinterpret_cast<unsigned int*>(smem_raw);
  ld_.dig = reinterpret_cast<unsigned char*>(ld_.row + E * rs);
  ld_.beta = reinterpret_cast<unsigned int*>(ld_.dig + E * ld_.ds);

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * E;
  const size_t tstride = static_cast<size_t>(cpad) << window;  // 2^w rows
  unsigned int* tab = table + e0 * tstride;  // this block's elements
  unsigned int* row = ld_.row;
  // Elements of this block past the batch compute on zero residues and
  // are never stored.
  const int live = B - static_cast<int>(e0) < E ? B - static_cast<int>(e0) : E;
  ld_.live = live;
  ld_.pstride = n_windows;
  ld_.prows = 1 << window;

  for (int idx = tid; idx < E * ld_.ds; idx += nt) ld_.dig[idx] = 0;
  for (int c = tid; c < cpad; c += nt) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      row[e * rs + c] =
          e < live ? static_cast<unsigned int>(x[(e0 + e) * cpad + c]) : 0u;
    }
  }
  __syncthreads();

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
  __syncthreads();
  for (int j = 2; j < (1 << window); ++j) {
    ld_.montmul(kYTable, tab, tstride, 1, nullptr);  // tab[j-1] * xd
    for (int c = tid; c < cpad; c += nt) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        tab[e * tstride + static_cast<size_t>(j) * cpad + c] = row[e * rs + c];
      }
    }
    __syncthreads();
  }

  for (int c = tid; c < cpad; c += nt) {
    const unsigned int one = ld(one_dom, c);
#pragma unroll
    for (int e = 0; e < E; ++e) row[e * rs + c] = one;
  }
  __syncthreads();
  for (int wi = 0; wi < n_windows; ++wi) {
    for (int s = 0; s < window; ++s) ld_.montmul(kYSelf, nullptr, 0, 0, nullptr);
    if (!kVec) {
      // Digits come from the host schedule, in [0, 2^window); the mask keeps
      // any other value inside this element's table.
      const int d = static_cast<int>(static_cast<const int64_t*>(digits)[wi]) &
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
      if (e < live) out[(e0 + e) * cpad + c] = static_cast<int64_t>(row[e * rs + c]);
    }
  }
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
  const int threads = warps_for(k) * 32;
  const int blocks = (B + E - 1) / E;
  rns_ladder_kernel<kVec, E><<<blocks, threads, smem, stream>>>(
      x, out, table, B, k, cpad, rows, mbinv,
      reinterpret_cast<const int4*>(w1p), reinterpret_cast<const int4*>(w2p),
      digits, n_windows, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// phe_rns_ladder_<E>: x, out: [B, cpad] int64 stored residues; table:
// uint32 scratch of ceil(B / E) * E * 2^window * cpad words; m ... one_dom:
// the system's [cpad] int64 constant rows; entry, exitc: [cpad] int64
// entry and exit constants; mbinv: [1] int64; w1p, w2p: the extension
// matrices in fragment order (cuda_rns.pack_blocks), 16-byte aligned;
// digits: [n_windows] int64. phe_rns_ladder_vec_<E> takes digits: [B,
// n_windows] int8, one MSB-first schedule per element. Each launches on
// `stream`, allocates nothing, and returns cudaGetLastError().
#define PHE_RNS_LADDER_ENTRY(NAME, VEC, E, DIGIT_T)                            \
  extern "C" int NAME(                                                         \
      const int64_t* x, int64_t* out, unsigned int* table, int B, int k,      \
      int cpad, const int64_t* m, const int64_t* mu, const int64_t* t14,      \
      const int64_t* sig1, const int64_t* sig2, const int64_t* d1,            \
      const int64_t* d2, const int64_t* e1, const int64_t* neg_mb,            \
      const int64_t* one_dom, const int64_t* entry, const int64_t* exitc,     \
      const int64_t* mbinv, const int* w1p, const int* w2p,                   \
      const DIGIT_T* digits, int n_windows, int window, cudaStream_t stream) { \
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
