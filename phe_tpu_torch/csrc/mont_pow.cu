// Windowed Montgomery exponentiation over 14-bit redundant limbs, with the
// exponent shared by the batch or one exponent per row.
//
// Replaces phe_tpu/ops/pallas_modexp.py: mont_pow_shared_cols (:252-312),
// whose kernel body is _pow_kernel (:199-248), and mont_pow_cols
// (:519-583), whose body is _pow_vec_kernel (:458-515). One kernel body
// serves both, as mont_mul.cu serves the two-operand and shared-b products:
// a template flag says whether the digits are shared or per row.
//
// What it computes: for a Montgomery-domain base x < 2.01 M (limbs in
// [0, 2^14]), a 2^w-entry table (tab[0] = R mod M, tab[1] = x,
// tab[j] = tab[j-1] * x), then n_windows windows of w squarings and one
// table product, MSB first. The output is congruent to x^e R mod M, limbs
// in [0, 2^14], value < 1.01 M: value-equal to the plain version
// (phe_tpu_torch.ops.montgomery.mont_pow_plain / mont_pow_shared_plain),
// not limb-equal. Every product is phe::mont_product (mont_core.cuh).
//
// Design: one block per row runs the whole modexp. The accumulator, the
// table ([2^w, L] uint32: 19 KB at L = 296, w = 4), the selected factor,
// M, M' and the product's 2 x 2L uint64 scratch all stay in shared memory,
// 4L (2^w + 4) + 32 L bytes in all (33 KB at L = 296, w = 4); nothing goes
// to device memory between products. The shared form indexes the table by
// the digit, as _pow_kernel does (:242): its exponent is the public key's.
// The per-row form selects in constant time, as _pow_vec_kernel's one-hot
// sum does (:503-512): every table row is read and the wanted one kept by
// a mask, with no address or branch that depends on the digit.
//
// Larger keys: at the 8192-bit geometry (L = 1176) the layout takes 131 KB
// at w = 4 and 207 KB at w = 5, both inside the 227 KB a block can have.
//
// What bounds it on an H100: integer multiply-add issue, as for
// mont_mul.cu. A product costs about 2.5 L^2 64-bit multiply-adds (219k at
// L = 296); a row of short obfuscation runs 14 + 80 * 5 = 414 of them
// (320-bit exponent, w = 4) and reads and writes 2 L int64 limbs, so
// device-memory traffic is negligible. 128 threads split each product's
// columns. Later work: the REDC products as int8 tensor-core matmuls, and
// several rows per block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mont_core.cuh"

namespace {

constexpr int kThreads = 128;

// dst <- a * b * R^-1 mod M; dst may alias a or b.
__device__ void mont_product_into(unsigned int* dst, const unsigned int* a,
                                  const unsigned int* b,
                                  const unsigned int* m,
                                  const unsigned int* mp,
                                  unsigned long long* t,
                                  unsigned long long* w, int L) {
  const unsigned long long* h = phe::mont_product(a, b, m, mp, t, w, L);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    dst[i] = static_cast<unsigned int>(h[i]);
  }
  __syncthreads();
}

// kVec = false: digits is int64 [n_windows], shared by the batch.
// kVec = true: digits is int8 [B, n_windows], one schedule per row.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mont_pow_kernel(const int64_t* __restrict__ base, int64_t* __restrict__ out,
                const int64_t* __restrict__ mod,
                const int64_t* __restrict__ mprime,
                const int64_t* __restrict__ one,
                const void* __restrict__ digits, int L, int n_windows,
                int window) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* t = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* w = t + 2 * L;
  unsigned int* sm = reinterpret_cast<unsigned int*>(w + 2 * L);
  unsigned int* sp = sm + L;
  unsigned int* acc = sp + L;
  unsigned int* fac = acc + L;  // the selected table factor (kVec)
  unsigned int* tab = fac + L;  // [2^w, L]
  const int ntab = 1 << window;

  const size_t row = blockIdx.x;
  const int64_t* brow = base + row * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    sm[i] = static_cast<unsigned int>(mod[i]);
    sp[i] = static_cast<unsigned int>(mprime[i]);
    tab[i] = static_cast<unsigned int>(one[i]);
    tab[L + i] = static_cast<unsigned int>(brow[i]);
    acc[i] = static_cast<unsigned int>(one[i]);
  }
  __syncthreads();
  for (int j = 2; j < ntab; ++j) {
    mont_product_into(tab + j * L, tab + (j - 1) * L, tab + L, sm, sp, t, w,
                      L);
  }

  const unsigned int mask = static_cast<unsigned int>(ntab - 1);
  for (int wi = 0; wi < n_windows; ++wi) {
    for (int s = 0; s < window; ++s) {
      mont_product_into(acc, acc, acc, sm, sp, t, w, L);
    }
    // Digits come from host schedules, in [0, 2^window); the mask keeps
    // any other value inside the table.
    const unsigned int* factor;
    if (kVec) {
      const unsigned int d =
          static_cast<unsigned int>(static_cast<const uint8_t*>(
              digits)[row * n_windows + wi]) & mask;
      for (int i = threadIdx.x; i < L; i += blockDim.x) {
        unsigned int v = 0;
        for (int j = 0; j < ntab; ++j) {
          v |= tab[j * L + i] &
               (0u - static_cast<unsigned int>(static_cast<unsigned int>(j) ==
                                               d));
        }
        fac[i] = v;
      }
      __syncthreads();
      factor = fac;
    } else {
      const int d = static_cast<int>(
          static_cast<const int64_t*>(digits)[wi] & mask);
      factor = tab + d * L;
    }
    mont_product_into(acc, acc, factor, sm, sp, t, w, L);
  }

  int64_t* orow = out + row * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    orow[i] = static_cast<int64_t>(acc[i]);
  }
}

template <bool kVec>
int launch(const int64_t* base, int64_t* out, const int64_t* mod,
           const int64_t* mprime, const int64_t* one, const void* digits,
           int B, int L, int n_windows, int window, cudaStream_t stream) {
  const size_t smem = 2 * 2 * L * sizeof(unsigned long long) +
                      (4 + (static_cast<size_t>(1) << window)) * L *
                          sizeof(unsigned int);
  cudaError_t err = cudaFuncSetAttribute(
      mont_pow_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mont_pow_kernel<kVec><<<B, kThreads, smem, stream>>>(
      base, out, mod, mprime, one, digits, L, n_windows, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// base, out: [B, L] int64 Montgomery-domain rows; mod, mprime, one: [L]
// int64 (M, M' and R mod M); digits: [n_windows] int64, MSB first. All on
// the device, contiguous. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int phe_mont_pow_shared(const int64_t* base, int64_t* out,
                                   const int64_t* mod, const int64_t* mprime,
                                   const int64_t* one, const int64_t* digits,
                                   int B, int L, int n_windows, int window,
                                   cudaStream_t stream) {
  return launch<false>(base, out, mod, mprime, one, digits, B, L, n_windows,
                       window, stream);
}

// As phe_mont_pow_shared, with digits: [B, n_windows] int8, one MSB-first
// schedule per row.
extern "C" int phe_mont_pow(const int64_t* base, int64_t* out,
                            const int64_t* mod, const int64_t* mprime,
                            const int64_t* one, const int8_t* digits, int B,
                            int L, int n_windows, int window,
                            cudaStream_t stream) {
  return launch<true>(base, out, mod, mprime, one, digits, B, L, n_windows,
                      window, stream);
}
