// Batched Montgomery product a * b * R^-1 mod M over 14-bit redundant
// limbs, E rows a block, both constant products of the reduction on the
// int8 tensor cores or on the CUDA cores' integer pipe, whichever the
// wrapper picks for the launch's shape.
//
// Replaces phe_tpu/ops/pallas_modexp.py: mont_mul_cols (call :378) and
// mont_mul_const_cols (call :434), whose kernel body is _mul_kernel
// (:324-340) -> _mont_mul_into (:155-196), both of its bodies: the MXU
// branch (:166-190) and the integer-pipe one (:192-196). One kernel body
// serves both forms: a template flag says whether b is one row per row of
// a or one row shared by the batch; a second (kMxu) picks the REDC body.
//
// What it computes: for a, b < 2.01 M with limbs in [0, 2^14], a result
// congruent to a b R^-1 mod M with limbs in [0, 2^14] and value < 1.01 M:
// value-equal to the plain version (montgomery.mont_mul_plain), not
// limb-equal.
//
// How: one product of the REDC tile (redc_tile.cuh). A block zeroes its
// shared memory, loads its `rows` (1 ... E, chosen per launch by the
// wrapper) rows of a into the accumulator and b into each live row's
// factor slot at the operand offset (in the shared form every live slot
// takes the same row), runs one product (a b on the CUDA cores in runs of
// kRun columns; q = T_lo M' mod R and q M as mma.sync int8 products over
// the rows against phe_tpu's REDC matrices, packed once per context; two
// carry passes), and writes the rows out as int64. There is no table.
// The integer-pipe body runs q = T_lo M' mod R and q M as two more a * b
// passes on the CUDA cores against M' and M in shared memory, its runs
// taken in falling order of cost; for a batch no larger than the card's
// SMs it runs the one-row tile (E = 1), each row on a thread-block
// cluster of `cluster` blocks that split every phase (redc_tile.cuh), the
// cluster's first block storing the row.
//
// What bounds it on an H100: per row 12 L^2 int8 multiply-adds of the
// reduction on the tensor cores (1.05 M at L = 296), L^2 int32
// multiply-adds of a b and the carry passes on the CUDA cores, and the
// packed matrices (12 L^2 bytes and their padding) from L2 once per block:
// 33 KB a row at L = 296, E = 32, and 2.1 MB at L = 1,176, E = 8. The
// operand rows in and out (24 L bytes a row, 16 L with b shared) are far
// below either. One block an SM (twelve warps, up to 232,448 bytes), so a
// launch of B rows runs ceil(B / rows) block-products in waves of the
// card's SMs. The integer-pipe body does about 2.5 L^2 int32
// multiply-adds a row (q's half product included) and reads no matrices:
// profiling.mont_mul_cost(L, mxu=False) counts 3 L^2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "redc_tile.cuh"

namespace {

using namespace phe;

// kShared = false: b is [B, L], one row per row of a.
// kShared = true: b is [L], shared by the batch.
// kMxu: the int8 REDC body (true) or the integer-pipe one (false).
template <bool kShared, int E, bool kMxu>
__global__ void __launch_bounds__(kThreads, 1)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                int64_t* __restrict__ out, const RedcConsts consts, int B,
                int rows, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cl = E == 1 ? cooperative_groups::this_cluster().num_blocks() : 1;
  const size_t e0 = static_cast<size_t>(blockIdx.x / cl) * rows;
  RedcTile<E, kMxu> p;
  p.init(smem_raw, L,
         B - static_cast<int>(e0) < rows ? B - static_cast<int>(e0) : rows,
         consts);
  const int live = p.live, sa = p.sa, sh = p.sh;

  p.zero();
  for (int idx = tid; idx < live * L; idx += nt) {
    const int e = idx / L, i = idx - e * L;
    p.acc[e * sa + kPad + i] =
        static_cast<unsigned int>(a[(e0 + e) * L + i]);
    p.H[e * sh + kPad + i] = static_cast<unsigned int>(
        b[kShared ? static_cast<size_t>(i) : (e0 + e) * L + i]);
  }
  __syncthreads();

  p.template product<false>();

  // A cluster's blocks hold the same row; its first one stores it. (No
  // block touches another's shared memory after the last cluster barrier
  // of the last product.)
  if (E == 1 && p.rank != 0) return;
  for (int idx = tid; idx < live * L; idx += nt) {
    const int e = idx / L, i = idx - e * L;
    out[(e0 + e) * L + i] = static_cast<int64_t>(p.acc[e * sa + kPad + i]);
  }
}

template <bool kShared, int E, bool kMxu>
int launch(const int64_t* a, const int64_t* b, int64_t* out,
           const RedcConsts& consts, int B, int rows, int cluster, int L,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(L, E, kMxu);
  if (smem > static_cast<size_t>(kSmemLimit) || L % kRun || L < kRun ||
      rows < 1 || rows > E ||
      (E == 1 ? cluster < 1 || cluster > kClusterMax : cluster != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      mont_mul_kernel<kShared, E, kMxu>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + rows - 1) / rows * cluster;
  if constexpr (E == 1) {
    err = launch_cluster(mont_mul_kernel<kShared, E, kMxu>, blocks, cluster,
                         smem, stream, a, b, out, consts, B, rows, L);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    mont_mul_kernel<kShared, E, kMxu><<<blocks, kThreads, smem, stream>>>(
        a, b, out, consts, B, rows, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// phe_mont_mul_<E>: a, b, out: [B, L] int64, `rows` (1 ... E) rows a
// block; wq, wm: w_mq and w_m in fragment order (cuda_rns.pack_blocks,
// two row blocks), 16-byte aligned; cq, cm: [2L] and [4L] int32
// compensation vectors. phe_mont_mul_const_<E> takes b: [L], shared by
// the batch. phe_mont_mul_int_<E> and phe_mont_mul_const_int_<E> reduce on
// the integer pipe and take mp, m: M' and M, int64 [L], in place of the
// matrices, and `cluster`: 1 for E = 8 and 32, the blocks of each row's
// cluster (1 ... 8) for E = 1. All on the device, contiguous. Each
// launches on `stream`, allocates nothing, and returns cudaGetLastError()
// (cudaErrorLaunchOutOfResources for a cluster the card cannot hold).
#define PHE_MONT_MUL_ENTRY(NAME, SHARED, E)                                   \
  extern "C" int NAME(const int64_t* a, const int64_t* b, int64_t* out,      \
                      const int* wq, const int* wm, const int* cq,           \
                      const int* cm, int B, int rows, int L,                 \
                      cudaStream_t stream) {                                 \
    return launch<SHARED, E, true>(a, b, out,                                \
                                   RedcConsts{wq, wm, cq, cm, nullptr,       \
                                              nullptr},                      \
                                   B, rows, 1, L, stream);                   \
  }
#define PHE_MONT_MUL_INT_ENTRY(NAME, SHARED, E)                               \
  extern "C" int NAME(const int64_t* a, const int64_t* b, int64_t* out,      \
                      const int64_t* mp, const int64_t* m, int B, int rows,  \
                      int cluster, int L, cudaStream_t stream) {             \
    return launch<SHARED, E, false>(                                         \
        a, b, out, RedcConsts{nullptr, nullptr, nullptr, nullptr, mp, m}, B, \
        rows, cluster, L, stream);                                           \
  }

PHE_MONT_MUL_ENTRY(phe_mont_mul_8, false, 8)
PHE_MONT_MUL_ENTRY(phe_mont_mul_32, false, 32)
PHE_MONT_MUL_ENTRY(phe_mont_mul_const_8, true, 8)
PHE_MONT_MUL_ENTRY(phe_mont_mul_const_32, true, 32)
PHE_MONT_MUL_INT_ENTRY(phe_mont_mul_int_8, false, 8)
PHE_MONT_MUL_INT_ENTRY(phe_mont_mul_int_32, false, 32)
PHE_MONT_MUL_INT_ENTRY(phe_mont_mul_const_int_8, true, 8)
PHE_MONT_MUL_INT_ENTRY(phe_mont_mul_const_int_32, true, 32)
PHE_MONT_MUL_INT_ENTRY(phe_mont_mul_int_1, false, 1)
PHE_MONT_MUL_INT_ENTRY(phe_mont_mul_const_int_1, true, 1)

// Shared-memory bytes of one block of `elems` rows at L (the tile's, as
// the modexp's) for the int8 body (mxu != 0) or the integer-pipe one: the
// GPU tests hold the wrapper's copy against it.
extern "C" int phe_mont_mul_smem(int L, int elems, int mxu) {
  return static_cast<int>(phe::smem_bytes(L, elems, mxu != 0));
}

// The clusters of `cluster` blocks of the one-row tile at L the card can
// hold at once (cudaOccupancyMaxActiveClusters), or a negative CUDA error.
extern "C" int phe_mont_mul_clusters(int L, int cluster) {
  const size_t smem = phe::smem_bytes(L, 1, false);
  const cudaError_t err = cudaFuncSetAttribute(
      mont_mul_kernel<false, 1, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  return phe::clusters_fit(reinterpret_cast<const void*>(mont_mul_kernel<false, 1, false>), cluster,
                           smem);
}
