// Constant-time selection of windowed-table rows for the shared-table
// encrypted matvec (batch._matvec): for every base i of a chunk
// [i0, i0 + dc) of the grid's bases, every row j and every window w,
//
//   out[i - i0, j, w] = table[digits[j, i, w], neg[j, i], i]
//
// where table[k, s, i] is c_i^k (s = 0) or c_i^-k (s = 1) in the limb
// Montgomery domain, so that a product tree over i then gives each (j, w)
// its window's factor of prod_i c_i^(+-x_ji).
//
// Replaces no TPU kernel: phe_tpu runs X^T [[d]] as one per-element
// modexp a grid element (ladder_vec_cols, whose port is the per-element
// RNS ladder of rns_ladder.cu). This kernel was added for the port's
// shared-table matvec, which builds each base's 16-row table once (32
// rows with its inverse's) and shares it over the grid's B rows and W
// windows, in place of B W per-element tables and ladders.
//
// In constant time, as the ladder's table select (rns_ladder.cu, montmul's
// kYPick branch): every output word is the OR of all `signs` x 16 staged
// rows, each ANDed with a mask that is all ones for the wanted row and
// zero for every other. No address and no branch depends on a digit or a
// sign: each thread reads every row at the same offsets whatever the
// digits, and the row index enters only the mask.
//
// Design. A block takes one base i and up to kOuts of its B W outputs
// (adjacent blocks share a base, so its table rows come from L2). It
// stages the base's rows in shared memory once, two 14-bit limbs a 32-bit
// word (the products' contract: limbs in [0, 2^14]; any limb below 2^16
// survives the packing), so a 16-fold read of each row stays on chip.
// Then each warp walks its outputs kBatch at a time: all its lanes read
// those outputs' digits and signs (broadcasts), then each lane takes two
// limbs a word at a time over the rows (neighbouring lanes on neighbouring
// words: no bank conflicts, and 16-byte stores side by side), reads each
// row's word once, ORs it under each output's mask into that output's
// word, and writes the outputs' two limbs out as int64, the products'
// input.
//
// What bounds it on an H100: the bytes written, 8 L a selection, and the
// tables read once (8 L signs x 16 a base), over 3.35 TB/s: at the 2048-bit
// key (L = 296), 13 rows, 30,000 bases and 24 windows, 22.2 GB and 2.3 GB,
// 7.3 ms. The on-chip reads, 2 L signs x 16 bytes a selection (177 GB
// there, 5.3 ms at the SMs' 33 TB/s of shared memory), take a quarter of
// that at kBatch = 4. Measured (NVIDIA H100 80GB HBM3, 700.00 W), that
// grid in 8 chunks of 4,096 bases: 9.65 ms (76 % of the bound; one output
// a warp at a time, 12.0 ms over 6 chunks), 4.3 % of the shared-table
// matvec's 226 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDigits = 16;  // rows a sign: the grid's window of 4 bits
constexpr int kOuts = 512;   // outputs a block, at most
// Outputs a warp selects at once: one shared-memory read of a row serves
// all of them.
constexpr int kBatch = 4;

template <int kSigns>
__global__ void __launch_bounds__(kThreads)
table_select_kernel(const int64_t* __restrict__ table,
                    const int8_t* __restrict__ digits,
                    const uint8_t* __restrict__ neg,
                    int64_t* __restrict__ out, int D, int B, int W, int i0,
                    int chunks, int L) {
  extern __shared__ __align__(16) uint32_t words[];  // [kSigns 16][L / 2]
  constexpr int kRows = kSigns * kDigits;
  const int c = blockIdx.x / chunks, i = i0 + c;
  const int o0 = (blockIdx.x - c * chunks) * kOuts;
  const int half = L >> 1, outs = B * W;
  const int o1 = outs - o0 < kOuts ? outs : o0 + kOuts;

  // Stage base i's rows r = s 16 + k (table[k, s, i]), two limbs a word.
  for (int idx = threadIdx.x; idx < kRows * half; idx += blockDim.x) {
    const int r = idx / half, p = idx - r * half;
    const int s = r / kDigits, k = r - s * kDigits;
    const longlong2 v = *reinterpret_cast<const longlong2*>(
        table + ((static_cast<size_t>(k) * kSigns + s) * D + i) * L + 2 * p);
    words[idx] = static_cast<uint32_t>(v.x) |
                 (static_cast<uint32_t>(v.y) << 16);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = (blockDim.x >> 5) * kBatch;
  for (int o = o0 + warp * kBatch; o < o1; o += stride) {
    // Digits come from the host schedule, in [0, 16); the mask keeps any
    // other value inside the table. A sign only where there are two. A
    // slot past the block's last output selects no row and stores nothing.
    int sel[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      sel[b] = -1;
      if (o + b < o1) {
        const int j = (o + b) / W;
        const size_t g = static_cast<size_t>(j) * D + i;
        sel[b] = (kSigns == 2 ? (neg[g] != 0) * kDigits : 0) +
                 (digits[g * W + o + b - j * W] & 15);
      }
    }
    int64_t* dst = out + (static_cast<size_t>(c) * outs + o) * L;
    for (int p = lane; p < half; p += 32) {
      uint32_t acc[kBatch] = {};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t word = words[r * half + p];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          acc[b] |= word & (0u - static_cast<uint32_t>(r == sel[b]));
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (o + b < o1) {
          longlong2 v;
          v.x = acc[b] & 0xffffu;
          v.y = acc[b] >> 16;
          *reinterpret_cast<longlong2*>(dst + static_cast<size_t>(b) * L +
                                        2 * p) = v;
        }
      }
    }
  }
}

template <int kSigns>
int launch(const int64_t* table, const int8_t* digits, const uint8_t* neg,
           int64_t* out, int D, int B, int W, int i0, int dc, int L,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kSigns) * kDigits * (L / 2) * 4;
  if (L % 2 || L < 2 || B < 1 || W < 1 || dc < 1 || i0 < 0 || i0 + dc > D ||
      smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      table_select_kernel<kSigns>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (B * W + kOuts - 1) / kOuts;
  const long long blocks = static_cast<long long>(dc) * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  table_select_kernel<kSigns><<<static_cast<unsigned int>(blocks), kThreads,
                                smem, stream>>>(table, digits, neg, out, D, B,
                                                W, i0, chunks, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// phe_table_select: table [16, signs, D, L] int64 (table[k, s, i]: base i
// to the power k, s = 1 its inverse's), digits [B, D, W] int8 schedules,
// neg [B, D] bool (read only where signs is 2), out [dc, B, W, L] int64:
// out[i - i0, j, w] = table[digits[j, i, w], neg[j, i], i] for i in
// [i0, i0 + dc). All on the device, contiguous, table and out 16-byte
// aligned; signs 1 or 2, L even.
// Launches on `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int phe_table_select(const int64_t* table, const int8_t* digits,
                                const uint8_t* neg, int64_t* out, int D,
                                int B, int W, int i0, int dc, int signs,
                                int L, cudaStream_t stream) {
  if (signs == 1) {
    return launch<1>(table, digits, neg, out, D, B, W, i0, dc, L, stream);
  }
  if (signs == 2) {
    return launch<2>(table, digits, neg, out, D, B, W, i0, dc, L, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
