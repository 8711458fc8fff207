// Chains of K serially dependent uint32 operations, one chain per element:
// the int32 issue-rate calibration behind the roofline (profiling.py).
//
// Replaces scripts/vpu_microbench.py: _mk (:30-37), the Pallas kernel
// (pl.pallas_call at :36) that runs a = body(a, x) K times over one
// [256, 512] uint32 tile, starting from a = x, with the five bodies of
// :62-75 (mul, add, muladd, shiftmul, barrett), all mod 2^32.
//
// What it computes: for each element, the same chain, on the int32 input
// reinterpreted as uint32; the output is the chain's last value, the same
// bit pattern as the plain version (ops/cuda_microbench.issue_chain_plain).
//
// What bounds it on an H100: int32 issue, K times the body's instructions
// per element on the busier of two pipes, the integer ALU and the FMA
// pipe that runs IMAD, each 64 lanes a clock an SM; its bytes (one word
// in, one out) are negligible. That is the point: the two-K difference of
// its times (phe_tpu_torch/microbench.py) is the card's sustained rate.
//
// Design: one thread per element runs its whole chain in a register. The
// body is a template parameter picked on the host, so the loop holds no
// branch on it. An empty asm statement on the accumulator in every
// iteration hides its value from the compiler, which could otherwise fold
// a chain such as a += x into a + K x, or hoist work out of the loop: a
// chain that is not executed measures nothing. The caller checks that the
// time scales with K. The barrier binds the front end only; ptxas still
// combines neighbouring iterations where one instruction does the work of
// two: on sm_90a, cuobjdump -sass shows add as one IADD3 (a + x + x) per
// two iterations and shiftmul's two successive shifts merged into one, so
// those two rows count more operations than instructions issued. mul (one
// IMAD an iteration), muladd (one IMAD) and barrett (eight instructions,
// four on each pipe, no merging) do not merge; the calibration takes mul
// and barrett. chip_smoke.py's CHAIN_ISSUE holds these counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Mul {
  __device__ static uint32_t step(uint32_t a, uint32_t x) { return a * x; }
};
struct Add {
  __device__ static uint32_t step(uint32_t a, uint32_t x) { return a + x; }
};
struct MulAdd {
  __device__ static uint32_t step(uint32_t a, uint32_t x) {
    return a * x + x;
  }
};
struct ShiftMul {
  __device__ static uint32_t step(uint32_t a, uint32_t x) {
    return ((a >> 14) * x) >> 14;
  }
};
// scripts/vpu_microbench.py:62-65: one Barrett-shaped reduction step.
struct Barrett {
  __device__ static uint32_t step(uint32_t a, uint32_t x) {
    const uint32_t q = ((a >> 14) * x) >> 14;
    const uint32_t r = a - q * x;
    return r >= x ? r - x : r;
  }
};

template <class Body>
__global__ void __launch_bounds__(kThreads)
issue_chain_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                   int n, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t xv = static_cast<uint32_t>(x[i]);
  uint32_t a = xv;
  for (int it = 0; it < K; ++it) {
    a = Body::step(a, xv);
    asm volatile("" : "+r"(a));
  }
  out[i] = static_cast<int32_t>(a);
}

template <class Body>
int launch(const int32_t* x, int32_t* out, int n, int K,
           cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  issue_chain_kernel<Body><<<blocks, kThreads, 0, stream>>>(x, out, n, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: n int32 on the device, contiguous; body: 0 mul, 1 add, 2 muladd,
// 3 shiftmul, 4 barrett. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown body).
extern "C" int phe_issue_chain(const int32_t* x, int32_t* out, int n, int K,
                               int body, cudaStream_t stream) {
  switch (body) {
    case 0: return launch<Mul>(x, out, n, K, stream);
    case 1: return launch<Add>(x, out, n, K, stream);
    case 2: return launch<MulAdd>(x, out, n, K, stream);
    case 3: return launch<ShiftMul>(x, out, n, K, stream);
    case 4: return launch<Barrett>(x, out, n, K, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
