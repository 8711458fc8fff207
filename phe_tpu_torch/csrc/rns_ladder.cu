// Windowed RNS Montgomery exponentiation ladder, with the exponent shared by
// the batch or one exponent per element.
//
// Replaces phe_tpu/ops/pallas_rns.py: ladder_cols (:177-244), whose kernel
// body is _ladder_kernel (:62-174), and ladder_vec_cols (:394-460), whose
// body is _ladder_vec_kernel (:265-391). The arithmetic is
// rns.rns_mont_mul's fused tau-domain Cox-Rower product (phe_tpu/ops/rns.py
// and phe_tpu_torch/ops/rns.py derive it and every bound): 28-bit channel
// products split h * 2^14 + l, steps=3 Barrett reductions, two int8 digit
// base extensions (w_ext1, w_ext2, [3(k+8), 2k]) with digit-block
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
// Design: one block runs kElems batch elements through the whole ladder.
// The accumulator, the raw channel products and the int8 digits of the
// current product stay in shared memory (kElems * (8 cpad + 2k) bytes:
// 44 KB at k = 304, cpad = 616); the table lives in a device-memory
// scratch the wrapper allocates ([B, 2^w, cpad] uint32), read once per
// window. Each base extension is, per output row, an int32 dot product
// over 2k int8 digits: one thread per output row, __dp4a over words of
// the matrix pre-packed as [2k/4, 3(k+8)] int32 so that neighbouring
// threads read neighbouring words, the element's digits broadcast from
// shared memory.
//
// Per-element exponents (ladder_vec): each element reads its own digit,
// [B, n_windows] int8 in device memory, masked to the window. The table
// factor is selected in constant time, as _ladder_vec_kernel's select
// tree (:366-385) is: every one of the 2^w rows is read and the wanted
// one kept by a mask, with no address or branch that depends on the
// digit, so the factor is exactly tab[d]. That costs 2^w table rows per
// window instead of one: 16 * cpad * 4 = 39 KB per element at w = 4,
// k = 304, against the w + 1 = 5 products of the window, each of which
// runs 2 * 3(k+8) * 2k = 1.14 M int8 multiply-adds per element. At the
// H100's 3.35 TB/s those bytes take about 4 % of the kernel's time (12 ms
// of 313 ms over 65,536 elements with 64-bit exponents, PERF.md). The
// select sits outside Ladder::montmul, so the shared-exponent form runs
// the same product code as without it.
//
// What bounds it on an H100: the extension matrices. Each product reads
// both (1.14 MB of int8 at k = 304) from L2, once per block, and runs
// 2 * 3(k+8) * 2k int8 multiply-adds per element (1.14 M at k = 304) as
// __dp4a on the integer pipes, not the tensor cores. Holding kElems
// elements per block divides the L2 traffic by kElems; the tensor cores
// (mma over the batch) are the step after this one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kElems = 8;        // batch elements per block
constexpr int kMaxThreads = 512;

enum YSource { kYSelf, kYTable, kYConst };

__device__ __forceinline__ unsigned int barrett(unsigned int x,
                                                unsigned int m,
                                                unsigned int mu) {
  // x < 2^30 -> x mod m; quotient error < 8 for m >= 4099 (steps=3).
  const unsigned int q = ((x >> 14) * mu) >> 14;
  unsigned int r = x - q * m;
  if (r >= (m << 2)) r -= m << 2;
  if (r >= (m << 1)) r -= m << 1;
  if (r >= m) r -= m;
  return r;
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

// The system's constant rows, each int64 [cpad], and the ladder's entry
// and exit constants.
struct Rows {
  const int64_t *m, *mu, *t14, *sig1, *sig2, *d1, *d2, *e1, *negmb, *one_dom;
  const int64_t *entry, *exitc;
};

struct Ladder {
  int k, cpad, K1;  // K1 = k + 8: rows of each extension's output
  const int64_t *m, *mu, *t14, *sig1, *sig2, *d1, *d2, *e1, *negmb;
  unsigned int mbinv;
  const int* w1p;  // [2k/4, 3 K1] packed int8 words
  const int* w2p;
  unsigned int* acc;    // shared [kElems, cpad]
  unsigned int* raw;    // shared [kElems, cpad]
  unsigned char* dig;   // shared [kElems, 2k]
  unsigned int* beta;   // shared [kElems]

  // acc <- acc * y (one RNS Montgomery product per element), where y is
  // acc itself, the table row `trow` of each element, or a constant.
  __device__ void montmul(YSource src, const unsigned int* tab, size_t tstride,
                          int trow, const int64_t* yconst) {
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int idx = tid; idx < kElems * cpad; idx += nt) {
      const int e = idx / cpad, c = idx - e * cpad;
      unsigned int y;
      if (src == kYSelf) {
        y = acc[idx];
      } else if (src == kYTable) {
        y = tab[e * tstride + static_cast<size_t>(trow) * cpad + c];
      } else {
        y = ld(yconst, c);
      }
      raw[idx] = acc[idx] * y;  // < 2^28
    }
    __syncthreads();

    // sigma over base A, as int8 digits (lo block, hi block).
    for (int idx = tid; idx < kElems * k; idx += nt) {
      const int e = idx / k, i = idx - e * k;
      const unsigned int r = raw[e * cpad + i];
      const unsigned int s = barrett(
          (r >> 14) * ld(sig2, i) + (r & 0x3FFF) * ld(sig1, i), ld(m, i),
          ld(mu, i));
      dig[e * 2 * k + i] = static_cast<unsigned char>(s & 0x7F);
      dig[e * 2 * k + k + i] = static_cast<unsigned char>(s >> 7);
    }
    __syncthreads();

    // Extension 1 -> q^, then u~ on B u r u pads (channels k + j).
    for (int j = tid; j < K1; j += nt) {
      int c0[kElems], c1[kElems], c2[kElems];
      extension(w1p, j, c0, c1, c2);
      const int ch = k + j;
      const unsigned int mj = ld(m, ch), muj = ld(mu, ch);
      const unsigned int t14j = ld(t14, ch), d1j = ld(d1, ch);
      const unsigned int d2j = ld(d2, ch), e1j = ld(e1, ch);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const unsigned int qh =
            barrett(combine_raw(c0[e], c1[e], c2[e], mj, muj, t14j), mj, muj);
        const unsigned int r = raw[e * cpad + ch];
        acc[e * cpad + ch] =
            barrett((r >> 14) * d2j + (r & 0x3FFF) * d1j + qh * e1j, mj, muj);
      }
    }
    __syncthreads();

    // The stored B residues are tau: their digits feed extension 2.
    for (int idx = tid; idx < kElems * k; idx += nt) {
      const int e = idx / k, j = idx - e * k;
      const unsigned int u = acc[e * cpad + k + j];
      dig[e * 2 * k + j] = static_cast<unsigned char>(u & 0x7F);
      dig[e * 2 * k + k + j] = static_cast<unsigned char>(u >> 7);
    }
    __syncthreads();

    // Extension 2 -> S on A u r u pads (row i < k: channel i; else 2k+i-k).
    for (int i = tid; i < K1; i += nt) {
      int c0[kElems], c1[kElems], c2[kElems];
      extension(w2p, i, c0, c1, c2);
      const int ch = i < k ? i : k + i;
      const unsigned int mi = ld(m, ch), mui = ld(mu, ch), t14i = ld(t14, ch);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        raw[e * cpad + i] = combine_raw(c0[e], c1[e], c2[e], mi, mui, t14i);
      }
    }
    __syncthreads();

    // beta from the redundant channel (S row k, u~ channel 2k).
    if (tid < kElems) {
      const unsigned int mr = ld(m, 2 * k), mur = ld(mu, 2 * k);
      const unsigned int sr = barrett(raw[tid * cpad + k], mr, mur);
      const unsigned int ur = acc[tid * cpad + 2 * k];
      beta[tid] = barrett((sr + (mr - ur)) * mbinv, mr, mur);
    }
    __syncthreads();

    for (int idx = tid; idx < kElems * k; idx += nt) {
      const int e = idx / k, i = idx - e * k;
      acc[e * cpad + i] = barrett(raw[e * cpad + i] + beta[e] * ld(negmb, i),
                                  ld(m, i), ld(mu, i));
    }
    __syncthreads();
  }

  // Output row r's three digit-block sums over every element's digits.
  __device__ void extension(const int* wp, int r, int* c0, int* c1,
                            int* c2) const {
#pragma unroll
    for (int e = 0; e < kElems; ++e) c0[e] = c1[e] = c2[e] = 0;
    const int words = (2 * k) / 4;
    const int row3 = 3 * K1;
    for (int j4 = 0; j4 < words; ++j4) {
      const int wa = __ldg(wp + j4 * row3 + r);
      const int wb = __ldg(wp + j4 * row3 + K1 + r);
      const int wc = __ldg(wp + j4 * row3 + 2 * K1 + r);
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const int d = reinterpret_cast<const int*>(dig + e * 2 * k)[j4];
        c0[e] = __dp4a(wa, d, c0[e]);
        c1[e] = __dp4a(wb, d, c1[e]);
        c2[e] = __dp4a(wc, d, c2[e]);
      }
    }
  }
};

// kVec = false: digits is int64 [n_windows], shared by the batch.
// kVec = true: digits is int8 [B, n_windows], one schedule per element.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
rns_ladder_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ out,
                  unsigned int* __restrict__ table, int B, int k, int cpad,
                  Rows rows, const int64_t* __restrict__ mbinv,
                  const int* __restrict__ w1p, const int* __restrict__ w2p,
                  const void* __restrict__ digits, int n_windows,
                  int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Ladder ld_;
  ld_.k = k;
  ld_.cpad = cpad;
  ld_.K1 = k + 8;
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
  ld_.acc = reinterpret_cast<unsigned int*>(smem_raw);
  ld_.raw = ld_.acc + kElems * cpad;
  ld_.dig = reinterpret_cast<unsigned char*>(ld_.raw + kElems * cpad);
  ld_.beta = reinterpret_cast<unsigned int*>(ld_.dig + kElems * 2 * k);

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t e0 = static_cast<size_t>(blockIdx.x) * kElems;
  const size_t tstride = static_cast<size_t>(cpad) << window;  // 2^w rows
  unsigned int* tab = table + e0 * tstride;  // this block's elements
  unsigned int* acc = ld_.acc;

  for (int idx = tid; idx < kElems * cpad; idx += nt) {
    const int e = idx / cpad, c = idx - e * cpad;
    acc[idx] = e0 + e < static_cast<size_t>(B)
                   ? static_cast<unsigned int>(x[(e0 + e) * cpad + c])
                   : 0u;
  }
  __syncthreads();

  // Enter the Montgomery domain; seed the table with 1 and xd.
  ld_.montmul(kYConst, nullptr, 0, 0, entry);
  for (int idx = tid; idx < kElems * cpad; idx += nt) {
    const int e = idx / cpad, c = idx - e * cpad;
    tab[e * tstride + c] = ld(one_dom, c);
    tab[e * tstride + cpad + c] = acc[idx];
  }
  __syncthreads();
  for (int j = 2; j < (1 << window); ++j) {
    ld_.montmul(kYTable, tab, tstride, 1, nullptr);  // tab[j-1] * xd
    for (int idx = tid; idx < kElems * cpad; idx += nt) {
      const int e = idx / cpad, c = idx - e * cpad;
      tab[e * tstride + static_cast<size_t>(j) * cpad + c] = acc[idx];
    }
    __syncthreads();
  }

  for (int idx = tid; idx < kElems * cpad; idx += nt) {
    acc[idx] = ld(one_dom, idx % cpad);
  }
  __syncthreads();
  for (int wi = 0; wi < n_windows; ++wi) {
    if (!kVec) {
      // Digits come from the host schedule, in [0, 2^window); the mask keeps
      // any other value inside this element's table.
      const int d = static_cast<int>(static_cast<const int64_t*>(digits)[wi]) &
                    ((1 << window) - 1);
      for (int s = 0; s < window; ++s) ld_.montmul(kYSelf, nullptr, 0, 0, nullptr);
      ld_.montmul(kYTable, tab, tstride, d, nullptr);
    } else {
      for (int s = 0; s < window; ++s) ld_.montmul(kYSelf, nullptr, 0, 0, nullptr);
      // Each element's own digit, masked to the window, selects its factor
      // in constant time: every table row is read and the wanted one kept
      // by a mask, with no address or branch that depends on the digit.
      // The factor goes to raw, which the product reads as a one-row table
      // (each thread reads y = raw[idx] before it overwrites raw[idx]).
      const uint8_t* dg = static_cast<const uint8_t*>(digits);
      const unsigned int mask = (1u << window) - 1;
      for (int idx = tid; idx < kElems * cpad; idx += nt) {
        const int e = idx / cpad, c = idx - e * cpad;
        const size_t el = e0 + e;
        const unsigned int d =
            el < static_cast<size_t>(B) ? dg[el * n_windows + wi] & mask : 0u;
        const unsigned int* col = tab + e * tstride + c;
        unsigned int y = 0;
        for (int j = 0; j < (1 << window); ++j) {
          y |= col[static_cast<size_t>(j) * cpad] &
               (0u - static_cast<unsigned int>(static_cast<unsigned int>(j) == d));
        }
        ld_.raw[idx] = y;
      }
      __syncthreads();
      ld_.montmul(kYTable, ld_.raw, cpad, 0, nullptr);
    }
  }
  // Leave the domain through the exit constant.
  ld_.montmul(kYConst, nullptr, 0, 0, exitc);

  for (int idx = tid; idx < kElems * cpad; idx += nt) {
    const int e = idx / cpad, c = idx - e * cpad;
    if (e0 + e < static_cast<size_t>(B)) {
      out[(e0 + e) * cpad + c] = static_cast<int64_t>(acc[idx]);
    }
  }
}

template <bool kVec>
int launch(const int64_t* x, int64_t* out, unsigned int* table, int B, int k,
           int cpad, const Rows& rows, const int64_t* mbinv, const int* w1p,
           const int* w2p, const void* digits, int n_windows, int window,
           cudaStream_t stream) {
  const size_t smem = kElems * (2 * cpad * sizeof(unsigned int) + 2 * k) +
                      kElems * sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      rns_ladder_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (k + 8 + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int blocks = (B + kElems - 1) / kElems;
  rns_ladder_kernel<kVec><<<blocks, threads, smem, stream>>>(
      x, out, table, B, k, cpad, rows, mbinv, w1p, w2p, digits, n_windows,
      window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: [B, cpad] int64 stored residues; table: uint32 scratch of
// ceil(B / 8) * 8 * 2^window * cpad words; m ... one_dom: the system's
// [cpad] int64 constant rows; entry, exitc: [cpad] int64 entry and exit
// constants; mbinv: [1] int64; w1p, w2p: [2k/4, 3(k+8)] int32 packed int8
// matrices; digits: [n_windows] int64. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int phe_rns_ladder(
    const int64_t* x, int64_t* out, unsigned int* table, int B, int k,
    int cpad, const int64_t* m, const int64_t* mu, const int64_t* t14,
    const int64_t* sig1, const int64_t* sig2, const int64_t* d1,
    const int64_t* d2, const int64_t* e1, const int64_t* neg_mb,
    const int64_t* one_dom, const int64_t* entry, const int64_t* exitc,
    const int64_t* mbinv, const int* w1p, const int* w2p,
    const int64_t* digits, int n_windows, int window, cudaStream_t stream) {
  const Rows rows{m, mu, t14, sig1, sig2, d1, d2, e1, neg_mb, one_dom,
                  entry, exitc};
  return launch<false>(x, out, table, B, k, cpad, rows, mbinv, w1p, w2p,
                       digits, n_windows, window, stream);
}

// As phe_rns_ladder, with digits: [B, n_windows] int8, one MSB-first
// schedule per element.
extern "C" int phe_rns_ladder_vec(
    const int64_t* x, int64_t* out, unsigned int* table, int B, int k,
    int cpad, const int64_t* m, const int64_t* mu, const int64_t* t14,
    const int64_t* sig1, const int64_t* sig2, const int64_t* d1,
    const int64_t* d2, const int64_t* e1, const int64_t* neg_mb,
    const int64_t* one_dom, const int64_t* entry, const int64_t* exitc,
    const int64_t* mbinv, const int* w1p, const int* w2p,
    const int8_t* digits, int n_windows, int window, cudaStream_t stream) {
  const Rows rows{m, mu, t14, sig1, sig2, d1, d2, e1, neg_mb, one_dom,
                  entry, exitc};
  return launch<true>(x, out, table, B, k, cpad, rows, mbinv, w1p, w2p,
                      digits, n_windows, window, stream);
}

// Elements per block: the wrapper sizes the table scratch with it.
extern "C" int phe_rns_ladder_elems() { return kElems; }
