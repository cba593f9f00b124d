// GF(2) bitmatrix apply on Hopper (sm_90a):
//   out[r, :] = XOR of packets[i, :] over the i with W[r, i] & 1,
// W [R, K] 0/1 bytes, packets [K, P] bytes, out [R, P] bytes.
//
// Replaces the TPU kernel xor_apply_pallas / _xor_kernel of
// ceph_tpu/ops/pallas_kernels.py:207 / :197 (its body is
// rs_kernels.bitplane_xor_matmul): the data path of the jerasure bitmatrix
// techniques (liberation, blaum_roth, liber8tion) and of the w=16/32
// wide-word codes, W = [m*w, k*w] for encode, [lost*w, k*w] for decode.
//
// The TPU kernel unpacks each byte into 8 bit-planes and runs an int8
// matmul mod 2 on the MXU.  On this card that would push 8x the bytes
// through the SMs for an op that needs only XORs, so this kernel computes
// the function, not that form: bytes stay bytes and one 32-bit XOR does
// four byte-XORs.
//
// What bounds it on this card: device-memory bytes for the encode shapes
// ((K + R) * P bytes at 3.35 TB/s, H100 SXM), with the XORs close behind on
// dense matrices (nnz(W) * P byte-XORs; a w=16 matrix is about half ones).
// The design:
//   - a warp owns a work item = (row group of RB output rows, 512-byte
//     column tile); a lane owns 16 bytes of it and keeps RB 16-byte
//     accumulators in registers (RB=16: 64 registers).  R up to 128 (w=32,
//     m=4) is R/RB row groups, not R accumulators;
//   - the warp walks the K input rows once per item: one 16-byte load per
//     lane per row (a masked byte path for ragged P and unaligned views),
//     XORed into the accumulators whose W bit is set; the W bits of 32
//     input rows at a time are gathered by the lanes (lane j reads column
//     i0+j of the group's rows) and broadcast with __shfl_sync, so W needs
//     no shared memory and any R, K fit;
//   - items are numbered row-group-fastest, so the warps of one block that
//     take the row groups of one tile run together and re-read its K rows
//     from L1/L2, not from device memory;
//   - a grid-stride loop over items takes any R, K and P with no padding.
// Not done yet (later work): cp.async/TMA staging of the packet tile, a
// persistent grid, XOR-combination tables to cut the per-bit work on dense
// matrices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 16;                 // output rows accumulated per item
constexpr int RUN = 16;                // bytes of one row a lane owns
constexpr int WARP = 32;
constexpr int TILE = WARP * RUN;       // columns of one work item
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / WARP;

template <bool VEC>
__device__ __forceinline__ uint4 load_run(const uint8_t* __restrict__ row,
                                          long long c0, long long p) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const long long c = c0 + q * 4 + b;
      if (c < p) w[q] |= (uint32_t)__ldg(row + c) << (8 * b);
    }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool VEC>
__device__ __forceinline__ void store_run(uint8_t* __restrict__ row,
                                          long long c0, long long p,
                                          uint4 v) {
  if (VEC) {
    *reinterpret_cast<uint4*>(row + c0) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (c0 + q * 4 + b < p) row[c0 + q * 4 + b] = (uint8_t)(w[q] >> (8 * b));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
xor_apply_kernel(const uint8_t* __restrict__ W,
                 const uint8_t* __restrict__ packets,
                 uint8_t* __restrict__ out, int R, int K, long long P) {
  const int lane = threadIdx.x & (WARP - 1);
  const int n_rg = (R + RB - 1) / RB;
  const long long items = ((P + TILE - 1) / TILE) * n_rg;
  const long long stride = (long long)gridDim.x * WARPS;
  // every bound below is the same for all lanes of a warp, so the
  // __shfl_sync calls always see the full warp
  for (long long item = (long long)blockIdx.x * WARPS + (threadIdx.x / WARP);
       item < items; item += stride) {
    const int r0 = (int)(item % n_rg) * RB;
    const int rows = min(RB, R - r0);
    const long long c0 = (item / n_rg) * TILE + (long long)lane * RUN;
    const bool live = c0 < P;
    uint4 acc[RB];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) acc[rr] = make_uint4(0, 0, 0, 0);

    for (int i0 = 0; i0 < K; i0 += WARP) {
      // lane j: bit rr of `mine` = W[r0 + rr, i0 + j] & 1
      uint32_t mine = 0;
      if (i0 + lane < K) {
        const uint8_t* wcol = W + (long long)r0 * K + i0 + lane;
        for (int rr = 0; rr < rows; ++rr)
          mine |= (uint32_t)(wcol[(long long)rr * K] & 1) << rr;
      }
      const int n = min(WARP, K - i0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const uint32_t m = __shfl_sync(0xffffffffu, mine, j);
        if (m == 0 || !live) continue;
        const uint4 v =
            load_run<VEC>(packets + (long long)(i0 + j) * P, c0, P);
#pragma unroll
        for (int rr = 0; rr < RB; ++rr) {
          if (m & (1u << rr)) {
            acc[rr].x ^= v.x;
            acc[rr].y ^= v.y;
            acc[rr].z ^= v.z;
            acc[rr].w ^= v.w;
          }
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int rr = 0; rr < RB; ++rr) {
      if (rr >= rows) break;
      store_run<VEC>(out + (long long)(r0 + rr) * P, c0, P, acc[rr]);
    }
  }
}

template <bool VEC>
cudaError_t launch(const uint8_t* W, const uint8_t* packets, uint8_t* out,
                   int R, int K, long long P, cudaStream_t stream) {
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, xor_apply_kernel<VEC>, THREADS, 0)) != cudaSuccess)
    return err;
  if (per_sm < 1) per_sm = 1;
  const long long items = ((P + TILE - 1) / TILE) * ((R + RB - 1) / RB);
  const long long blocks = (items + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(blocks < cap ? blocks : cap);
  xor_apply_kernel<VEC><<<grid, THREADS, 0, stream>>>(W, packets, out, R, K,
                                                      P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [R, P] = W [R, K] ·GF(2) packets [K, P], all uint8 and contiguous on
// the current device; bit 0 of each W byte is read.  K = 0 writes zeros.
// Launches on `stream`, allocates nothing, and returns the cudaError_t of
// the launch.
int xor_apply_launch(const void* W, const void* packets, void* out, int R,
                     int K, long long P, void* stream) {
  if (R < 1 || K < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)packets % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0) && (P % 16 == 0);
  const auto* w = static_cast<const uint8_t*>(W);
  const auto* p = static_cast<const uint8_t*>(packets);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<true>(w, p, o, R, K, P, s)
                   : launch<false>(w, p, o, R, K, P, s));
}

}  // extern "C"
