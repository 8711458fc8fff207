// Batched Montgomery product a * b * R^-1 mod M over 14-bit redundant limbs.
//
// Replaces phe_tpu/ops/pallas_modexp.py: mont_mul_cols (:343-391) and
// mont_mul_const_cols (:399-447), whose kernel body is _mul_kernel
// (:324-340) -> _mont_mul_into (:155-196). One kernel serves both: b is
// either one row per element or one row shared by the whole batch.
//
// What it computes (the contract phe_tpu's tests state for its kernel):
// for a, b < 2.01 M with limbs in [0, 2^14] and R = 2^(14 L) >= 2^16 M,
// out == a * b * R^-1 (mod M), limbs in [0, 2^14], value < 1.01 M. The
// limbs need not equal the Pallas kernel's redundant limbs, only the value.
//
// Design: one block per batch row, threads over output columns. The three
// products of Montgomery's reduction are schoolbook column sums
//   T = a * b                 (2L columns)
//   q = (T mod R) * M' mod R  (L columns)
//   U = T + q * M             (2L columns)
// each column a sum of up to L products below 2^28, accumulated in 64 bits
// (a 32-bit column would overflow after 16 terms), then three parallel
// carry passes restore limbs <= 2^14 (a column < 2^38 leaves < 2^14 + 2^24
// after one pass, < 2^14 + 2^11 after two, <= 2^14 after three). U is an
// exact multiple of R whose low half is 0 or exactly R, so U / R is the high
// half plus one iff any low limb is non-zero. The TPU kernel runs the two
// reduction products as int8 matmuls on the MXU; here they stay schoolbook.
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

namespace {

constexpr int kLimbBits = 14;
constexpr unsigned long long kMask = (1ull << kLimbBits) - 1;
constexpr int kThreads = 128;

// dst[i] = (src[i] & mask) + (src[i-1] >> 14); the top carry is dropped.
__device__ void carry_pass(const unsigned long long* src,
                           unsigned long long* dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    unsigned long long v = src[i] & kMask;
    if (i > 0) v += src[i - 1] >> kLimbBits;
    dst[i] = v;
  }
  __syncthreads();
}

// Three carry passes over n slots of x, using tmp; returns the buffer that
// holds the result (tmp). The caller has synchronised after writing x.
__device__ unsigned long long* carry_fix(unsigned long long* x,
                                         unsigned long long* tmp, int n) {
  carry_pass(x, tmp, n);
  carry_pass(tmp, x, n);
  carry_pass(x, tmp, n);
  return tmp;
}

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

  // T = a * b: column c sums a[i] * b[c - i].
  for (int c = threadIdx.x; c < 2 * L; c += blockDim.x) {
    const int lo = c > L - 1 ? c - (L - 1) : 0;
    const int hi = c < L - 1 ? c : L - 1;
    unsigned long long s = 0;
    for (int i = lo; i <= hi; ++i) s += sa[i] * sb[c - i];
    t[c] = s;
  }
  __syncthreads();
  unsigned long long* T = carry_fix(t, w, 2 * L);  // T lives in w

  // q = (T mod R) * M' mod R: the low L columns only; the carries dropped
  // out of the top limb are multiples of R.
  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    unsigned long long s = 0;
    for (int i = 0; i <= c; ++i) {
      s += static_cast<unsigned int>(T[i]) * sp[c - i];
    }
    t[c] = s;
  }
  __syncthreads();
  const unsigned long long* q = carry_fix(t, t + L, L);  // q lives in t[L:]

  // U = T + q * M, in place over T (each thread owns its columns).
  for (int c = threadIdx.x; c < 2 * L; c += blockDim.x) {
    const int lo = c > L - 1 ? c - (L - 1) : 0;
    const int hi = c < L - 1 ? c : L - 1;
    unsigned long long s = T[c];
    for (int i = lo; i <= hi; ++i) {
      s += static_cast<unsigned int>(q[i]) * sm[c - i];
    }
    T[c] = s;
  }
  __syncthreads();
  const unsigned long long* U = carry_fix(T, t, 2 * L);  // U lives in t

  // U / R: the high half, plus one iff any low limb is non-zero.
  int nonzero = 0;
  for (int i = threadIdx.x; i < L; i += blockDim.x) nonzero |= U[i] != 0;
  const unsigned long long carry = __syncthreads_or(nonzero) ? 1 : 0;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    w[i] = U[L + i] + (i == 0 ? carry : 0);
  }
  __syncthreads();
  const unsigned long long* H = carry_fix(w, w + L, L);

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
