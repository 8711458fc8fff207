// Windowed Montgomery exponentiation over 14-bit redundant limbs, with the
// exponent shared by the batch or one exponent per row, E rows a block and
// both constant products of each reduction on the int8 tensor cores or on
// the CUDA cores' integer pipe, whichever the wrapper picks for the
// launch's shape.
//
// Replaces phe_tpu/ops/pallas_modexp.py: mont_pow_shared_cols (call :302),
// whose kernel body is _pow_kernel (:199-248), and mont_pow_cols (call
// :570), whose body is _pow_vec_kernel (:458-515), each with both of
// _mont_mul_into's REDC bodies (the MXU one, and the integer-pipe one its
// kernels branch to at :200 and :469). One kernel body serves all four: a
// template flag says whether the digits are shared or per row, another
// (kMxu) which REDC body each product runs (redc_tile.cuh).
//
// What it computes: for a Montgomery-domain base x < 2.01 M (limbs in
// [0, 2^14]), a 2^w-entry table (tab[0] = R mod M, tab[1] = x,
// tab[j] = tab[j-1] * x), then n_windows windows of w squarings and one
// table product, MSB first. The output is congruent to x^e R mod M, limbs
// in [0, 2^14], value < 1.01 M: value-equal to the plain version
// (phe_tpu_torch.ops.montgomery.mont_pow_plain / mont_pow_shared_plain),
// not limb-equal.
//
// Each Montgomery product is one product of the REDC tile
// (redc_tile.cuh): a b on the CUDA cores in runs of kRun columns held in
// registers, q = T_lo M' mod R and q M as mma.sync int8 products over the
// block's rows against phe_tpu's REDC matrices, two-pass run carries. A
// table product takes its factor in the tile's H; a squaring reads acc
// twice and sums each cross term once.
//
// A block holds `rows` of its E row slots (1 ... E, chosen per launch by
// the wrapper): E when the batch fills the card, fewer when ceil(B / E)
// blocks would leave multiprocessors idle, the other slots' MMA columns
// zero. The integer-pipe body has a third tile for a batch no larger than
// the card's SMs: one row (E = 1) shared by a thread-block cluster of
// `cluster` blocks (1 ... 8), each holding the whole row and doing 1/C of
// every phase (redc_tile.cuh). The window table lives in device memory (a
// scratch of 2^w L words a row slot for each of the grid's blocks, which
// the wrapper allocates); the blocks of a cluster keep one copy each, and
// the cluster's first block stores the row.
// The shared form reads the entry its public digit names; the per-row
// form selects in constant time, as _pow_vec_kernel's one-hot sum
// (:503-512) does: every table entry is read and the wanted one kept by a
// mask, with no address or branch that depends on the digit.
//
// What bounds it on an H100: per row-product 12 L^2 int8 multiply-adds
// (1.05 M at L = 296) on the tensor cores, about 0.6 L^2 int32
// multiply-adds of a b (squarings halved) and the carry passes on the CUDA
// cores, and the packed matrices (12 L^2 bytes and their padding) from L2
// once per block-product: 33 KB a row-product at L = 296, E = 32, and
// 2.1 MB at L = 1,176, E = 8. Twelve warps a block, one block an SM. So a
// block holding fewer rows saves a b and carries but streams the same
// matrices: past about 0.5 GB a product over all blocks (POW_STREAM in
// ops/cuda_modexp.py), more blocks stop paying. The integer-pipe body
// streams no matrices and does about 2.5 L^2 int32 multiply-adds a
// product (2 L^2 a squaring).
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; SM clock stamps of block 0
// per product): at L = 296, E = 32, 124 k cycles a block-product, a b
// 36 %, the two MMA phases 35 %, carries and digits the rest; at L = 1,176,
// E = 8, 490 k cycles, the matrix stream 66 % (about 50 bytes a clock an
// SM) and a b 30 %. Staging the fragments in registers (__ldg, any depth)
// kept about one K-step of loads in flight a warp and the stream near 29
// bytes a clock; the cp.async ring lifted it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "redc_tile.cuh"

namespace {

using namespace phe;

// kVec = false: digits is int64 [n_windows], shared by the batch.
// kVec = true: digits is int8 [B, n_windows], one schedule per row.
// kMxu: the int8 REDC body (true) or the integer-pipe one (false).
template <bool kVec, int E, bool kMxu>
__global__ void __launch_bounds__(kThreads, 1)
mont_pow_kernel(const int64_t* __restrict__ base, int64_t* __restrict__ out,
                unsigned int* __restrict__ table,
                const int64_t* __restrict__ one, const RedcConsts consts,
                const void* __restrict__ digits, int B, int rows, int L,
                int n_windows, int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cl = E == 1 ? cooperative_groups::this_cluster().num_blocks() : 1;
  const size_t e0 = static_cast<size_t>(blockIdx.x / cl) * rows;
  RedcTile<E, kMxu> p;
  p.init(smem_raw, L,
         B - static_cast<int>(e0) < rows ? B - static_cast<int>(e0) : rows,
         consts);
  const int live = p.live, sa = p.sa, sh = p.sh;
  const int ntab = 1 << window;
  const size_t tstride = static_cast<size_t>(ntab) * L;  // a row's table
  unsigned int* tab =
      table + static_cast<size_t>(blockIdx.x) * rows * tstride;

  // Zero everything, then the rows: acc = x; tab[0] = R mod M, tab[1] = x.
  p.zero();
  for (int idx = tid; idx < live * L; idx += nt) {
    const int e = idx / L, i = idx - e * L;
    const unsigned int x = static_cast<unsigned int>(base[(e0 + e) * L + i]);
    p.acc[e * sa + kPad + i] = x;
    tab[e * tstride + i] = static_cast<unsigned int>(one[i]);
    tab[e * tstride + L + i] = x;
  }
  __syncthreads();

  // The factor into H at the operand offset, its pads zero: table entry
  // `j` of each row (sel: each row's own digit for window wi, selected in
  // constant time).
  auto load_factor = [&](int j, bool sel, int wi) {
    const int span = L + 2 * kPad;
    for (int idx = tid; idx < live * span; idx += nt) {
      const int e = idx / span, i = idx - e * span - kPad;
      unsigned int v = 0;
      if (i >= 0 && i < L) {
        const unsigned int* col = tab + e * tstride + i;
        if (sel) {
          const unsigned int d =
              static_cast<unsigned int>(static_cast<const uint8_t*>(
                  digits)[(e0 + e) * n_windows + wi]) &
              static_cast<unsigned int>(ntab - 1);
          for (int jj = 0; jj < ntab; ++jj) {
            v |= col[static_cast<size_t>(jj) * L] &
                 (0u - static_cast<unsigned int>(
                           static_cast<unsigned int>(jj) == d));
          }
        } else {
          v = col[static_cast<size_t>(j) * L];
        }
      }
      p.H[e * sh + i + kPad] = v;
    }
    __syncthreads();
  };

  for (int j = 2; j < ntab; ++j) {
    load_factor(1, false, 0);
    p.template product<false>();  // acc = tab[j-1] * x
    for (int idx = tid; idx < live * L; idx += nt) {
      const int e = idx / L, i = idx - e * L;
      tab[e * tstride + static_cast<size_t>(j) * L + i] =
          p.acc[e * sa + kPad + i];
    }
  }
  for (int idx = tid; idx < live * L; idx += nt) {
    const int e = idx / L, i = idx - e * L;
    p.acc[e * sa + kPad + i] = static_cast<unsigned int>(one[i]);
  }
  __syncthreads();

  for (int wi = 0; wi < n_windows; ++wi) {
    for (int s = 0; s < window; ++s) p.template product<true>();
    if (kVec) {
      load_factor(0, true, wi);
    } else {
      // Digits come from the host schedule, in [0, 2^window); the mask
      // keeps any other value inside the table.
      load_factor(static_cast<int>(static_cast<const int64_t*>(digits)[wi]) &
                      (ntab - 1),
                  false, 0);
    }
    p.template product<false>();
  }

  // A cluster's blocks hold the same row; its first one stores it. (No
  // block touches another's shared memory after the last cluster barrier
  // of the last product.)
  if (E == 1 && p.rank != 0) return;
  for (int idx = tid; idx < live * L; idx += nt) {
    const int e = idx / L, i = idx - e * L;
    out[(e0 + e) * L + i] = static_cast<int64_t>(p.acc[e * sa + kPad + i]);
  }
}

template <bool kVec, int E, bool kMxu>
int launch(const int64_t* base, int64_t* out, unsigned int* table,
           const int64_t* one, const RedcConsts& consts, const void* digits,
           int B, int rows, int cluster, int L, int n_windows, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(L, E, kMxu);
  if (smem > static_cast<size_t>(kSmemLimit) || L % kRun || L < 16 ||
      window < 1 || window > 8 || rows < 1 || rows > E ||
      (E == 1 ? cluster < 1 || cluster > kClusterMax : cluster != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      mont_pow_kernel<kVec, E, kMxu>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + rows - 1) / rows * cluster;
  if constexpr (E == 1) {
    err = launch_cluster(mont_pow_kernel<kVec, E, kMxu>, blocks, cluster,
                         smem, stream, base, out, table, one, consts, digits,
                         B, rows, L, n_windows, window);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    mont_pow_kernel<kVec, E, kMxu><<<blocks, kThreads, smem, stream>>>(
        base, out, table, one, consts, digits, B, rows, L, n_windows, window);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// phe_mont_pow_shared_<E>: base, out: [B, L] int64 Montgomery-domain rows,
// `rows` (1 ... E) of them a block; table: uint32 scratch of
// ceil(B / rows) * cluster * rows * 2^window * L words; one: [L]
// int64 R mod M; wq, wm: w_mq and w_m in fragment order
// (cuda_rns.pack_blocks, two row blocks), 16-byte aligned; cq, cm: [2L]
// and [4L] int32 compensation vectors; digits: [n_windows] int64, MSB
// first. phe_mont_pow_<E> takes digits: [B, n_windows] int8, one schedule
// per row. phe_mont_pow_shared_int_<E> and phe_mont_pow_int_<E> reduce on
// the integer pipe and take mp, m: M' and M, int64 [L], in place of the
// matrices, and `cluster`: 1 for E = 8 and 32, the blocks of each row's
// cluster (1 ... 8) for E = 1. All on the device, contiguous. Each
// launches on `stream`, allocates nothing, and returns cudaGetLastError()
// (cudaErrorLaunchOutOfResources for a cluster the card cannot hold).
#define PHE_MONT_POW_ENTRY(NAME, VEC, E, DIGIT_T)                              \
  extern "C" int NAME(const int64_t* base, int64_t* out, unsigned int* table, \
                      const int64_t* one, const int* wq, const int* wm,       \
                      const int* cq, const int* cm, const DIGIT_T* digits,    \
                      int B, int rows, int L, int n_windows, int window,      \
                      cudaStream_t stream) {                                  \
    return launch<VEC, E, true>(                                              \
        base, out, table, one,                                                \
        RedcConsts{wq, wm, cq, cm, nullptr, nullptr}, digits, B, rows, 1, L,  \
        n_windows, window, stream);                                           \
  }
#define PHE_MONT_POW_INT_ENTRY(NAME, VEC, E, DIGIT_T)                          \
  extern "C" int NAME(const int64_t* base, int64_t* out, unsigned int* table, \
                      const int64_t* one, const int64_t* mp,                  \
                      const int64_t* m, const DIGIT_T* digits, int B,         \
                      int rows, int cluster, int L, int n_windows,            \
                      int window, cudaStream_t stream) {                      \
    return launch<VEC, E, false>(                                             \
        base, out, table, one,                                                \
        RedcConsts{nullptr, nullptr, nullptr, nullptr, mp, m}, digits, B,     \
        rows, cluster, L, n_windows, window, stream);                         \
  }

PHE_MONT_POW_ENTRY(phe_mont_pow_shared_8, false, 8, int64_t)
PHE_MONT_POW_ENTRY(phe_mont_pow_shared_32, false, 32, int64_t)
PHE_MONT_POW_ENTRY(phe_mont_pow_8, true, 8, int8_t)
PHE_MONT_POW_ENTRY(phe_mont_pow_32, true, 32, int8_t)
PHE_MONT_POW_INT_ENTRY(phe_mont_pow_shared_int_8, false, 8, int64_t)
PHE_MONT_POW_INT_ENTRY(phe_mont_pow_shared_int_32, false, 32, int64_t)
PHE_MONT_POW_INT_ENTRY(phe_mont_pow_int_8, true, 8, int8_t)
PHE_MONT_POW_INT_ENTRY(phe_mont_pow_int_32, true, 32, int8_t)
PHE_MONT_POW_INT_ENTRY(phe_mont_pow_shared_int_1, false, 1, int64_t)
PHE_MONT_POW_INT_ENTRY(phe_mont_pow_int_1, true, 1, int8_t)

// Shared-memory bytes of one block of `elems` rows at L for the int8 body
// (mxu != 0) or the integer-pipe one (elems 1: the one-row tile): the
// wrapper chooses E with its own copy of this formula, which the GPU tests
// hold against this one.
extern "C" int phe_mont_pow_smem(int L, int elems, int mxu) {
  return static_cast<int>(phe::smem_bytes(L, elems, mxu != 0));
}

// The clusters of `cluster` blocks of the one-row tile at L the card can
// hold at once (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
extern "C" int phe_mont_pow_clusters(int L, int cluster) {
  const size_t smem = phe::smem_bytes(L, 1, false);
  const cudaError_t err = cudaFuncSetAttribute(
      mont_pow_kernel<false, 1, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  return phe::clusters_fit(reinterpret_cast<const void*>(mont_pow_kernel<false, 1, false>), cluster,
                           smem);
}
