// The Montgomery product over 14-bit redundant limbs in shared memory: the
// device routine shared by mont_mul.cu (one product per row) and
// mont_pow.cu (a whole windowed modexp per row).
//
// For a, b < 2.01 M with limbs in [0, 2^14] and R = 2^(14 L) >= 2^16 M,
// the result is congruent to a * b * R^-1 (mod M), with limbs in
// [0, 2^14] and value < 1.01 M (phe_tpu's contract for its Pallas kernel).
//
// The three products of Montgomery's reduction are schoolbook column sums
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

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace phe {

constexpr int kLimbBits = 14;
constexpr unsigned long long kMask = (1ull << kLimbBits) - 1;

// dst[i] = (src[i] & mask) + (src[i-1] >> 14); the top carry is dropped.
__device__ inline void carry_pass(const unsigned long long* src,
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
__device__ inline unsigned long long* carry_fix(unsigned long long* x,
                                                unsigned long long* tmp,
                                                int n) {
  carry_pass(x, tmp, n);
  carry_pass(tmp, x, n);
  carry_pass(x, tmp, n);
  return tmp;
}

// a * b * R^-1 mod M for [L] uint32 operands in shared memory (a and b may
// be the same buffer); m, mp: M and M' = -M^-1 mod R, [L] uint32 in shared
// memory; t, w: [2L] uint64 shared scratch each. Every thread of the block
// calls it, after a barrier that publishes a and b. Returns the [L] result
// limbs, which live in w[L:2L] until the next call; a and b are no longer
// read, so the caller may overwrite either with the result.
__device__ inline const unsigned long long* mont_product(
    const unsigned int* a, const unsigned int* b, const unsigned int* m,
    const unsigned int* mp, unsigned long long* t, unsigned long long* w,
    int L) {
  // T = a * b: column c sums a[i] * b[c - i].
  for (int c = threadIdx.x; c < 2 * L; c += blockDim.x) {
    const int lo = c > L - 1 ? c - (L - 1) : 0;
    const int hi = c < L - 1 ? c : L - 1;
    unsigned long long s = 0;
    for (int i = lo; i <= hi; ++i) {
      s += static_cast<unsigned long long>(a[i] * b[c - i]);
    }
    t[c] = s;
  }
  __syncthreads();
  unsigned long long* T = carry_fix(t, w, 2 * L);  // T lives in w

  // q = (T mod R) * M' mod R: the low L columns only; the carries dropped
  // out of the top limb are multiples of R.
  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    unsigned long long s = 0;
    for (int i = 0; i <= c; ++i) {
      s += static_cast<unsigned long long>(static_cast<unsigned int>(T[i]) *
                                           mp[c - i]);
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
      s += static_cast<unsigned long long>(static_cast<unsigned int>(q[i]) *
                                           m[c - i]);
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
  return carry_fix(w, w + L, L);
}

}  // namespace phe
