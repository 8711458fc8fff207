// Batched Montgomery product a * b * R^-1 mod M over 14-bit redundant limbs.
//
// Replaces phe_tpu/ops/pallas_modexp.py: mont_mul_cols (:343-391) and
// mont_mul_const_cols (:399-447), whose kernel body is _mul_kernel
// (:324-340) -> _mont_mul_into (:155-196). One kernel serves both: b is
// either one row per element or one row shared by the whole batch.
//
// What it computes, and how: phe::mont_product (mont_core.cuh), the
// Montgomery product over 14-bit redundant limbs with schoolbook column
// sums in 64 bits and three parallel carry passes. The output limbs need
// not equal the Pallas kernel's redundant limbs, only the value mod M.
//
// What bounds it on an H100: integer multiply-add issue. A row costs about
// 2.5 L^2 64-bit multiply-adds (219k at L = 296) and reads and writes only
// 3 L int64 limbs, far below the memory bound. One block per row keeps
// every row's work in shared memory (48 L bytes: 14 KB at L = 296) with no
// traffic to device memory between the steps; 128 threads split the
// columns. Later work: 32-bit split accumulators and several rows per
// block to share the loads of M and M'.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mont_core.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int64_t* __restrict__ a, const int64_t* __restrict__ b,
                const int64_t* __restrict__ mod,
                const int64_t* __restrict__ mprime,
                int64_t* __restrict__ out, int L, int b_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* t = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* w = t + 2 * L;
  unsigned int* sa = reinterpret_cast<unsigned int*>(w + 2 * L);
  unsigned int* sb = sa + L;
  unsigned int* sm = sb + L;
  unsigned int* sp = sm + L;

  const size_t row = blockIdx.x;
  const int64_t* arow = a + row * L;
  const int64_t* brow = b + row * b_stride;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    sa[i] = static_cast<unsigned int>(arow[i]);
    sb[i] = static_cast<unsigned int>(brow[i]);
    sm[i] = static_cast<unsigned int>(mod[i]);
    sp[i] = static_cast<unsigned int>(mprime[i]);
  }
  __syncthreads();
  const unsigned long long* H = phe::mont_product(sa, sb, sm, sp, t, w, L);

  int64_t* orow = out + row * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    orow[i] = static_cast<int64_t>(H[i]);
  }
}

}  // namespace

// a: [B, L] int64; b: [B, L] int64 (b_shared = 0) or [L] (b_shared = 1);
// mod, mprime: [L] int64; out: [B, L] int64. All on the device, contiguous.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int phe_mont_mul(const int64_t* a, const int64_t* b,
                            const int64_t* mod, const int64_t* mprime,
                            int64_t* out, int B, int L, int b_shared,
                            cudaStream_t stream) {
  const size_t smem = 2 * 2 * L * sizeof(unsigned long long) +
                      4 * L * sizeof(unsigned int);
  mont_mul_kernel<<<B, kThreads, smem, stream>>>(a, b, mod, mprime, out, L,
                                                 b_shared ? 0 : L);
  return static_cast<int>(cudaGetLastError());
}
