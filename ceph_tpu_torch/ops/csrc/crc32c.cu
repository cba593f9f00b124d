// crc32c (Castagnoli, seed 0, no final xor) of each row of a byte matrix on
// Hopper (sm_90a): rows uint8 [r, n] with a row stride -> uint32 [r].
//
// Replaces the jitted XLA function crc32c_rows of ceph_tpu/ops/rs_kernels.py
// (body _crc_rows_body), which gathers a per-byte crc and folds adjacent
// blocks level by level as Z_len(left) ^ right.  It runs on the EC write
// path under ecutil.hinfo_append (the per-shard HashInfo checksums) and
// in rs_kernels.gf_encode_with_crc (fused encode + checksum).
//
// What bounds it on this card: device-memory bytes, r * n read once (a
// 4 MiB object at RS(8,4) is 12 rows of 512 KiB: 0.0019 ms at 3.35 TB/s),
// as long as the shared-memory table lookups (one per byte) keep up; at
// one object the launch dominates.  The design is the simple one:
//   - crc32c is GF(2)-linear, and for a zero seed leading zero bytes leave
//     the register at 0, so a row is padded with zeros on the LEFT to a
//     whole number of segments of SEG bytes.  Padded position p is real
//     byte p - pad; the pad is never read, only treated as zero;
//   - a block takes one segment at a time (a grid-stride loop over
//     rows * segments); each of its THREADS threads runs slicing-by-8
//     (the byte tables T0..T7 of ecutil._CRC_TABLES, staged once per block
//     in shared memory) over its own RUN contiguous bytes, with 16-byte
//     loads where the run is aligned and bytes otherwise;
//   - the runs fold as Z_{len(right)}(left) ^ right: five levels across
//     the lanes of a warp by shuffles, three across the block's warps in
//     shared memory.  Z_L is the 32x32 GF(2) operator advancing a register
//     through L zero bytes (ecutil.crc32c_zeros_op), held as the images
//     of the 32 register bits; the host builds Z_{2^j} once;
//   - the segment's crc is advanced through the bytes after it, its
//     distance split into powers of two, and XORed into the row's output
//     with atomicXor (the wrapper zeroes the output on the same stream).
// Not tuned: the tables' lookups conflict in shared memory, and a warp's
// loads are RUN bytes apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LOG_RUN = 8;
constexpr int RUN = 1 << LOG_RUN;               // bytes per thread
constexpr int LOG_SEG = LOG_RUN + 8;            // THREADS = 2^8
constexpr long long SEG = 1LL << LOG_SEG;       // bytes per segment (64 KiB)
constexpr int ZPOW = 48;                        // Z_{2^j}, j < 48

// op[i] is the image of register bit i
__device__ __forceinline__ uint32_t apply_op(const uint32_t* op, uint32_t v) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) out ^= op[i] & (0u - ((v >> i) & 1u));
  return out;
}

__device__ __forceinline__ uint32_t step8(const uint32_t* t, uint32_t c,
                                          uint32_t lo, uint32_t hi) {
  c ^= lo;
  return t[7 * 256 + (c & 0xff)] ^ t[6 * 256 + ((c >> 8) & 0xff)] ^
         t[5 * 256 + ((c >> 16) & 0xff)] ^ t[4 * 256 + (c >> 24)] ^
         t[3 * 256 + (hi & 0xff)] ^ t[2 * 256 + ((hi >> 8) & 0xff)] ^
         t[1 * 256 + ((hi >> 16) & 0xff)] ^ t[hi >> 24];
}

__global__ void __launch_bounds__(THREADS)
crc32c_rows_kernel(const uint8_t* __restrict__ rows, long long stride, int r,
                   long long n, long long nseg,
                   const uint32_t* __restrict__ tables,
                   const uint32_t* __restrict__ zpow,
                   uint32_t* __restrict__ out) {
  __shared__ uint32_t tab[8 * 256];
  __shared__ uint32_t fold[8][32];        // Z_{RUN << l}, l < 8
  __shared__ uint32_t wcrc[WARPS];
  for (int i = threadIdx.x; i < 8 * 256; i += THREADS) tab[i] = tables[i];
  fold[threadIdx.x >> 5][threadIdx.x & 31] =
      zpow[(LOG_RUN + (threadIdx.x >> 5)) * 32 + (threadIdx.x & 31)];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long pad = nseg * SEG - n;
  const long long total = (long long)r * nseg;
  for (long long g = blockIdx.x; g < total; g += gridDim.x) {
    const long long row = g / nseg;
    const long long s = g % nseg;
    const uint8_t* base = rows + row * stride;
    // real bytes [a, a + RUN); bytes before 0 are the zero pad
    const long long a = s * SEG + (long long)threadIdx.x * RUN - pad;
    uint32_t c = 0;
    if (a >= 0 && ((uintptr_t)(base + a) & 15) == 0) {
      const uint4* p = reinterpret_cast<const uint4*>(base + a);
#pragma unroll 4
      for (int i = 0; i < RUN / 16; ++i) {
        const uint4 x = p[i];
        c = step8(tab, c, x.x, x.y);
        c = step8(tab, c, x.z, x.w);
      }
    } else if (a + RUN > 0) {
      for (int i = 0; i < RUN; i += 8) {
        uint32_t w[2] = {0, 0};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const long long p = a + i + q;
          if (p >= 0) w[q >> 2] |= (uint32_t)base[p] << (8 * (q & 3));
        }
        c = step8(tab, c, w[0], w[1]);
      }
    }
    // lanes: after level l, lane 2^(l+1)k - 1 holds its 2^(l+1) runs
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const uint32_t left = __shfl_up_sync(0xffffffffu, c, 1 << l);
      const uint32_t folded = apply_op(fold[l], left) ^ c;
      if ((lane & ((2 << l) - 1)) == (2 << l) - 1) c = folded;
    }
    if (lane == 31) wcrc[warp] = c;
    __syncthreads();
    if (warp == 0) {
      c = lane < WARPS ? wcrc[lane] : 0;
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        const uint32_t left = __shfl_up_sync(0xffffffffu, c, 1 << l);
        const uint32_t folded = apply_op(fold[5 + l], left) ^ c;
        if ((lane & ((2 << l) - 1)) == (2 << l) - 1) c = folded;
      }
      if (lane == WARPS - 1) {
        // advance through the (nseg - 1 - s) segments after this one
        unsigned long long d = (unsigned long long)(nseg - 1 - s);
        for (int j = LOG_SEG; d; ++j, d >>= 1)
          if (d & 1) c = apply_op(zpow + j * 32, c);
        if (c) atomicXor(out + row, c);
      }
    }
    __syncthreads();                      // wcrc is rewritten next segment
  }
}

}  // namespace

extern "C" {

// crc32c(0, row) of rows [r, n] (row i at rows + i * stride) XORed into
// out[r], which the caller zeroes on the same stream.  tables: the slicing
// tables T0..T7 as [8, 256] words; zpow: Z_{2^j} for j < 48 as [48, 32]
// words (word i of operator j = image of register bit i).  n < 2^47.
// Returns the cudaError_t of the launch.
int crc32c_rows_launch(const void* rows, long long stride, int r, long long n,
                       const void* tables, const void* zpow, void* out,
                       void* stream) {
  if (r < 1 || n < 1 || stride < n || n >= (1LL << (ZPOW - 1)))
    return (int)cudaErrorInvalidValue;
  const long long nseg = (n + SEG - 1) / SEG;
  const long long total = (long long)r * nseg;
  int dev = 0, sms = 0, fit = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &fit, crc32c_rows_kernel, THREADS, 0)) != cudaSuccess)
    return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * fit;
  const int grid = (int)(total < cap ? total : cap);
  crc32c_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), stride, r, n, nseg,
      static_cast<const uint32_t*>(tables), static_cast<const uint32_t*>(zpow),
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
