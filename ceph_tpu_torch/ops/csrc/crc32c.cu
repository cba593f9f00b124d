// crc32c (Castagnoli, seed 0, no final xor) of each row of a byte matrix on
// Hopper (sm_90a): rows uint8 [r, n] with a row stride -> int64 [r].
//
// Replaces the jitted XLA function crc32c_rows of ceph_tpu/ops/rs_kernels.py
// (body _crc_rows_body), which gathers a per-byte crc and folds adjacent
// blocks level by level as Z_len(left) ^ right.  It runs on the EC write
// path under ecutil.hinfo_append (the per-shard HashInfo checksums), in
// rs_kernels.gf_encode_with_crc (fused encode + checksum) and in every
// recovery wave's hash check of the rebuilt shards.
//
// What bounds it on this card: device-memory bytes, r * n read once (a
// 4 MiB object at RS(8,4) is 12 rows of 512 KiB: 0.0019 ms at 3.35 TB/s;
// [8, 32 Mi] 0.080 ms), as long as the shared-memory table lookups keep
// up: at two conflict-free 32-lane lookups a byte and one shared load a
// clock per SM they alone need about 0.064 ms at [8, 32 Mi].  At one
// object the launch and the first loads dominate.
//
// What held the first design back (slicing-by-8, one thread per 256-byte
// run, 64 KiB segments, atomicXor into an output the wrapper zeroed):
//   - eight byte-table lookups a step with data-dependent indices, so a
//     warp's lookups conflicted across banks;
//   - each thread loaded its own run, so one 16-byte load of a warp
//     touched 32 places 256 B apart, with nothing in flight ahead;
//   - 64 KiB work units: [12, 512 Ki] gave 96 of them for 132 SMs,
//     [2, 512 Ki] 16;
//   - three launches a call (zero the output, the kernel, widen to int64)
//     and the fold operators read from device memory.
// This design:
//   - split-nibble tables replicated per lane: for the 8-byte step
//     c' = crc of (c ^ lo, hi), nibble t of the 64 bits looks up table
//     N_t[e] = T_{7 - t/2}[e << 4(t%2)] (T_j the slicing tables of
//     ecutil._CRC_TABLES), word (t*16 + e)*32 + lane, so lane l always
//     reads bank l: 16 lookups a step, none conflicting.  The tables sit
//     at a 2 KiB-aligned shared address, so a lookup's address is one
//     shift and one LOP3 (base | nibble << 7) and the table number is the
//     load's immediate offset (rs_kernels.crc_nibble_tables);
//   - warp work units of SPAN = 4 KiB: lane l owns run l of RUN = 128
//     bytes.  Each warp has its own 2-stage cp.async ring: neighbouring
//     lanes copy neighbouring 16 B of the unit, and runs land RUN + 16
//     bytes apart, so the lanes' 16-byte reads of their runs hit distinct
//     banks.  The next unit's loads are in flight while this one's
//     lookups run, and only __syncwarp orders a warp's ring;
//   - a warp's unit crc is XOR over lanes of Z_{(31-l)*RUN}(c_l): each lane
//     applies its own operator through 8 per-lane nibble tables
//     (rs_kernels.crc_lane_tables), and 5 xor-shuffles reduce.  Z_L is the
//     32x32 GF(2) operator advancing a register through L zero bytes.
//     Two chains a lane, over the run's halves, measured no faster at
//     [8, 32 Mi] (0.1356 against 0.1361 ms of device time, path_shapes.py,
//     NVIDIA H100 80GB HBM3 at 700 W);
//   - a persistent grid (one 512-thread block per SM) splits the r * nspan
//     units into one contiguous chunk per warp; a warp folds its units by
//     Horner, acc = Z_SPAN(acc) ^ unit, with Z_SPAN's images in a register
//     per lane, and at a row's end or its chunk's end advances acc through
//     the units after it (Z_{2^j} from shared memory, applied by the
//     warp: lane i masks image i, 5 shuffles reduce) and atomicXors it
//     into the row's output;
//   - one launch a call: a cooperative launch keeps every block resident,
//     so the blocks zero the int64 output, meet at one grid barrier (the
//     first unit's loads already in flight), and XOR into it.  No
//     zeroing or widening launch is left;
//   - rows are padded with zeros on the LEFT to whole units (free for a
//     zero seed: the register stays 0); a 16-byte piece that is pad,
//     straddles the pad or is not 16-byte aligned is assembled from byte
//     loads, so any row stride or alignment works.
// Limits (the wrapper raises first): r >= 1, n >= 1, stride >= n,
// n < 2^47.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int LOG_RUN = 7;
constexpr int RUN = 1 << LOG_RUN;               // bytes a lane owns per unit
constexpr int LOG_SPAN = LOG_RUN + 5;
constexpr long long SPAN = 1LL << LOG_SPAN;     // bytes of one warp unit
constexpr int RUN_STRIDE = RUN + 16;            // padded run in the ring
constexpr int STAGE = 32 * RUN_STRIDE;          // one unit in the ring
constexpr int STAGES = 2;
constexpr int PIECES = (int)(SPAN / 16 / 32);   // 16-byte copies per lane
constexpr int ZPOW = 48;                        // Z_{2^j}, j < 48
constexpr int NIB_BYTES = 16 * 16 * 32 * 4;     // data tables, per lane
constexpr int LANE_BYTES = 8 * 16 * 32 * 4;     // lane fold tables
constexpr int ZPOW_BYTES = ZPOW * 32 * 4;
constexpr int ALIGN = 2048;                     // tables' base alignment
constexpr int SMEM = ALIGN + NIB_BYTES + LANE_BYTES + ZPOW_BYTES +
                     WARPS * STAGES * STAGE;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// sum over the 8 nibbles t of x of entry (nibble t) of table T0 + t;
// base = the tables' 2 KiB-aligned shared address | lane * 4, so the
// address is base | nibble << 7 and the table is the load's offset
template <int T0>
__device__ __forceinline__ uint32_t look8(uint32_t base, uint32_t x) {
  uint32_t c = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int sh = 4 * t - 7;
    const uint32_t off = (sh >= 0 ? x >> sh : x << -sh) & 0x780u;
    c ^= lds((base | off) + (T0 + t) * 16 * 32 * 4);
  }
  return c;
}

// warp-wide: the operator whose image of register bit i is op_i (lane i's
// word) applied to the warp-uniform v
__device__ __forceinline__ uint32_t warp_apply(uint32_t op_i, uint32_t v,
                                               int lane) {
  uint32_t y = op_i & (0u - ((v >> lane) & 1u));
#pragma unroll
  for (int o = 16; o; o >>= 1) y ^= __shfl_xor_sync(FULL, y, o);
  return y;
}

// stage the 16-byte pieces of unit (row, s) a lane copies into a ring slot
__device__ __forceinline__ void stage_unit(const uint8_t* rows,
                                           long long stride, long long row,
                                           long long s, long long pad,
                                           uint32_t slot, int lane) {
  const uint8_t* base = rows + row * stride;
  const long long a0 = s * SPAN - pad;      // real offset of the unit
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int w = i * 32 + lane;            // piece of the unit
    const uint32_t dst = slot + (w >> 3) * RUN_STRIDE + (w & 7) * 16;
    const long long a = a0 + w * 16;
    const uintptr_t src = (uintptr_t)base + (uintptr_t)a;
    if (a >= 0 && (src & 15) == 0) {
      cp_async16(dst, reinterpret_cast<const void*>(src));
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < 16; ++q)
        if (a + q >= 0)
          v[q >> 2] |= (uint32_t)__ldg(reinterpret_cast<const uint8_t*>(
                           src + q)) << (8 * (q & 3));
      sts128(dst, make_uint4(v[0], v[1], v[2], v[3]));
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
crc32c_rows_kernel(const uint8_t* __restrict__ rows, long long stride, int r,
                   long long n, long long nspan,
                   const uint32_t* __restrict__ nib,
                   const uint32_t* __restrict__ lanetab,
                   const uint32_t* __restrict__ zpow,
                   unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t s_nib = (s0 + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t s_lane = s_nib + NIB_BYTES;
  const uint32_t s_zpow = s_lane + LANE_BYTES;
  const uint32_t s_ring = s_zpow + ZPOW_BYTES;
  uint32_t* g_nib = reinterpret_cast<uint32_t*>(smem + (s_nib - s0));
  uint32_t* g_lane = reinterpret_cast<uint32_t*>(smem + (s_lane - s0));
  uint32_t* g_zpow = reinterpret_cast<uint32_t*>(smem + (s_zpow - s0));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t ring = s_ring + warp * STAGES * STAGE;

  const long long pad = nspan * SPAN - n;
  const long long total = (long long)r * nspan;
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long gw = (long long)blockIdx.x * WARPS + warp;
  const long long u0 = total * gw / nwarps;
  const long long u1 = total * (gw + 1) / nwarps;
  // the first unit's loads go out before anything else
  long long row = u0 / nspan, s = u0 % nspan;
  if (u0 < u1) stage_unit(rows, stride, row, s, pad, ring, lane);
  cp_async_commit();

  // unrolled, so that every load is in flight before the first store
#pragma unroll
  for (int i = 0; i < NIB_BYTES / 4 / THREADS; ++i) {
    const int w = i * THREADS + threadIdx.x;
    g_nib[w] = __ldg(nib + (w >> 5));
  }
#pragma unroll
  for (int i = 0; i < LANE_BYTES / 4 / THREADS; ++i)
    g_lane[i * THREADS + threadIdx.x] = __ldg(lanetab + i * THREADS +
                                              threadIdx.x);
#pragma unroll
  for (int i = 0; i < ZPOW * 32 / THREADS; ++i)
    g_zpow[i * THREADS + threadIdx.x] = __ldg(zpow + i * THREADS +
                                              threadIdx.x);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < r;
       i += (long long)gridDim.x * THREADS)
    out[i] = 0;
  cg::this_grid().sync();       // outputs zeroed, tables staged

  const uint32_t tab = s_nib | (uint32_t)(lane * 4);
  const uint32_t ltab = s_lane | (uint32_t)(lane * 4);
  const uint32_t zspan = lds(s_zpow + (LOG_SPAN * 32 + lane) * 4);
  long long nrow = row, ns = s;             // the unit staged next
  uint32_t acc = 0;
  for (long long u = u0; u < u1; ++u) {
    const uint32_t cur = ring + (uint32_t)((u - u0) & 1) * STAGE;
    if (++ns == nspan) { ns = 0; ++nrow; }
    if (u + 1 < u1)
      stage_unit(rows, stride, nrow, ns, pad,
                 ring + (uint32_t)((u + 1 - u0) & 1) * STAGE, lane);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    // the lane's run, 8 bytes a step
    const uint32_t run = cur + lane * RUN_STRIDE;
    uint32_t c = 0;
#pragma unroll 2
    for (int i = 0; i < RUN / 16; ++i) {
      const uint4 x = lds128(run + i * 16);
      c = look8<0>(tab, c ^ x.x) ^ look8<8>(tab, x.y);
      c = look8<0>(tab, c ^ x.z) ^ look8<8>(tab, x.w);
    }
    __syncwarp();                           // the slot is refilled next
    // unit crc and Horner in one reduction:
    // acc = Z_SPAN(acc) ^ xor_l Z_{(31-l)*RUN}(c_l)
    uint32_t y = look8<0>(ltab, c) ^ (zspan & (0u - ((acc >> lane) & 1u)));
#pragma unroll
    for (int o = 16; o; o >>= 1) y ^= __shfl_xor_sync(FULL, y, o);
    acc = y;
    if (s == nspan - 1 || u + 1 == u1) {
      // through the (nspan - 1 - s) units after this one, then into out
      unsigned long long d = (unsigned long long)(nspan - 1 - s);
      for (int j = LOG_SPAN; d; ++j, d >>= 1)
        if (d & 1) acc = warp_apply(lds(s_zpow + (j * 32 + lane) * 4), acc,
                                    lane);
      if (lane == 0 && acc) atomicXor(out + row, (unsigned long long)acc);
      acc = 0;
    }
    row = nrow;
    s = ns;
  }
  cp_async_wait<0>();
}

struct DeviceInfo {
  int sms = 0, fit = 0;
};

}  // namespace

extern "C" {

// crc32c(0, row) of rows [r, n] (row i at rows + i * stride) written to
// out[r] as int64 on `stream`, in one cooperative launch.  nib: the
// split-nibble tables [16, 16] words (rs_kernels.crc_nibble_tables);
// lanetab: the lane fold tables [8, 16, 32] words
// (rs_kernels.crc_lane_tables); zpow: Z_{2^j} for j < 48 as [48, 32] words
// (word i of operator j = image of register bit i).  n < 2^47.  Returns
// the cudaError_t of the launch.
int crc32c_rows_launch(const void* rows, long long stride, int r, long long n,
                       const void* nib, const void* lanetab, const void* zpow,
                       void* out, void* stream) {
  if (r < 1 || n < 1 || stride < n || n >= (1LL << (ZPOW - 1)))
    return (int)cudaErrorInvalidValue;
  static DeviceInfo info[64];
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  DeviceInfo& di = info[dev];
  if (di.fit < 1) {
    if ((err = cudaFuncSetAttribute(
             crc32c_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             SMEM)) != cudaSuccess)
      return (int)err;
    int sms = 0, fit = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &fit, crc32c_rows_kernel, THREADS, SMEM)) != cudaSuccess)
      return (int)err;
    if (fit < 1) return (int)cudaErrorInvalidConfiguration;
    di.sms = sms;
    di.fit = fit;
  }
  const long long nspan = (n + SPAN - 1) / SPAN;
  const long long total = (long long)r * nspan;
  const long long want = (total + WARPS - 1) / WARPS;
  const long long cap = (long long)di.sms * di.fit;
  const int grid = (int)(want < cap ? want : cap);
  const uint8_t* rows_p = static_cast<const uint8_t*>(rows);
  const uint32_t* nib_p = static_cast<const uint32_t*>(nib);
  const uint32_t* lane_p = static_cast<const uint32_t*>(lanetab);
  const uint32_t* zpow_p = static_cast<const uint32_t*>(zpow);
  unsigned long long* out_p = static_cast<unsigned long long*>(out);
  void* args[] = {&rows_p, &stride, &r, &n, (void*)&nspan, &nib_p, &lane_p,
                  &zpow_p, &out_p};
  err = cudaLaunchCooperativeKernel((const void*)crc32c_rows_kernel,
                                    dim3(grid), dim3(THREADS), args, SMEM,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
