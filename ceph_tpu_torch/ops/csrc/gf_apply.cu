// GF(2^8) matrix apply on Hopper (sm_90a): out = mat ·GF(2^8) data.
//
// Replaces two TPU kernels of ceph_tpu/ops/pallas_kernels.py with one:
//   gf_apply_pallas / _gf_kernel                     [k, N] -> [r, N]
//     (stripes = 1; rs_kernels.gf_apply)
//   gf_apply_stripes_pallas / _gf_stripes_kernel     vertical layout
//     [S*k, N] -> [S*r, N] (rs_kernels.gf_apply_stripes)
//
// Times below: NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md).
//
// What bounds it on this card: device-memory bytes, (k + r) * N per call
// (12 bytes per 8 data bytes at RS(8,4), against 3.35 TB/s on the H100
// SXM), as long as the shared-memory lookups stay under that time.  The
// first version (one 256-entry byte table per coefficient, r*k byte
// lookups per column with bank conflicts, loads started only as the loop
// reached them) took 0.3035 ms at [4,8] x [8, 32 Mi], 40% of the bound:
// its r*k = 32 byte lookups per column alone needed ~0.128 ms at one
// conflict-free 32-lane shared load per SM clock.  This design:
//   - packed split-nibble tables: for a group of RB = 4 output rows and
//     data row j, T_lo[j][e] = sum_q (mat[4g+q][j] * e) << 8q and
//     T_hi[j][e] = sum_q (mat[4g+q][j] * (e << 4)) << 8q, e in 0..15, so
//     T_lo[b & 15] ^ T_hi[b >> 4] holds the products of byte b with the 4
//     rows' coefficients: 2k 32-bit lookups per column instead of r*k byte
//     lookups.  A thread accumulates the 16 columns of each run as 16
//     packed words and turns them into 4 row words of 16 bytes with 4x4
//     __byte_perm transposes before the 16-byte stores
//     (rs_kernels.packed_nibble_tables is the same table in plain PyTorch);
//   - the tables are replicated per lane, word (e, lane) at e*32 + lane, so
//     lane l always reads bank l: every lookup is conflict-free.  One
//     (group, data row) takes 2*16*32*4 = 4 KiB, 32 KiB at r=4, k=8;
//   - a per-thread cp.async ring: each thread streams its own 16-byte runs
//     (RUNS of them, THREADS*16 bytes apart) of KD data rows per chunk into
//     STAGES shared-memory slots, starting the chunk STAGES-1 ahead before
//     it works on the current one, so 64 KiB per block (one per SM at the
//     defaults) are in flight while the lookups run.  A thread reads only
//     the slots it filled, so the ring needs no barrier;
//   - a persistent grid (as many blocks as fit on the SMs, from the
//     occupancy query) walks (stripe, column tile), and the chunk stream
//     runs on across tiles, so the next tile's loads overlap this tile's
//     last lookups.  A block builds its tables while its first chunks load.
// Tables are built in the kernel from mat and the device's 64 KiB MUL table.
// Where all (group, data row) tables fit (n_groups * k <= TAB_ROWS) they
// are staged once per block; wider matrices (the codec admits k + m <= 256)
// re-stage one group's tables in slices of TAB_ROWS data rows per tile.
// Output rows past 4 take one pass over the data per group of 4.
// Measured (ceph_tpu_torch/tools/sweep_stripes.py and
// path_shapes.py): at [4,8] x [8, 32 Mi] 0.155 ms, 77% of the bytes bound
// and 90% of the copy ceiling; the headline 64 x [8, 128 Ki] 0.046 ms,
// 65% and 84%.  Staging the tables with one distinct word per thread, 32 lane
// copies each (not 32 threads loading the same word), took 15% off the
// headline.  Variants tried: STAGES 2/3/4/6, RUNS 1/2, 1-3 blocks per SM;
// one block per SM with RUNS = 1 was slowest, the rest within about 15%,
// and STAGES = 3 with RUNS = 2 (one block per SM) was at or near the best
// at both shapes, so it is the default.
// Still open: a TMA (cp.async.bulk) ring, and one pass for r > 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RB = 4;               // output rows packed in one word
constexpr int KD = 4;               // data rows per ring chunk
constexpr int TAB_ROWS = 16;        // (group, data row) tables kept at most
constexpr int TAB_BYTES = 2 * 16 * 32 * 4;   // one (group, data row) table
constexpr int RUN = 16;             // bytes of one row a thread owns per run
constexpr int DEFAULT_STAGES = 3;    // sweep_stripes' best on the H100
constexpr int DEFAULT_RUNS = 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

// Tables of groups [g0, g0 + ng) x data rows [j0, j0 + nj), table index
// (g - g0) * nj + (j - j0); word (h, e, lane) of a table is
// sum_q MUL[mat[4g+q][j]][h ? e << 4 : e] << 8q (zero past r or k).  A
// thread computes one distinct word u = (table, h, e) per pass (one round
// of global loads for the block's 256 words at r = 4, k = 8) and writes its
// 32 lane copies, lane l of the warp at step i writing copy (i + l) % 32,
// so the 32 stores of a step fall in 32 banks.
__device__ void stage_tables(uint32_t* tab, const uint8_t* __restrict__ mat,
                             const uint8_t* __restrict__ mul, int r, int k,
                             int g0, int ng, int j0, int nj) {
  const int lane = threadIdx.x & 31;
  const int words = ng * nj * (TAB_BYTES / 4 / 32);
  for (int u = threadIdx.x; u < words; u += blockDim.x) {
    const int e = u & 15;
    const int h = (u >> 4) & 1;
    const int t = u >> 5;
    const int g = g0 + t / nj;
    const int j = j0 + t % nj;
    const int b = h ? e << 4 : e;
    uint32_t v = 0;
    if (j < k) {
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int i = g * RB + q;
        if (i < r) v |= (uint32_t)mul[(int)mat[i * k + j] * 256 + b] << (8 * q);
      }
    }
    uint32_t* dst = tab + u * 32;
#pragma unroll
    for (int i = 0; i < 32; ++i) dst[(i + lane) & 31] = v;
  }
}

// (stripe, tile of the row, row group, chunk) in the order a block walks
// them: tiles blockIdx.x, blockIdx.x + gridDim.x, ... of stripes *
// tiles_per_row, held as (stripe, tile in row) so no step divides
struct Cursor {
  long long s, t;
  int rg, ch;
  // ds, dt: gridDim.x as (stripes, tiles) of tpr tiles per row
  __device__ void next(int n_rg, int n_ch, long long ds, long long dt,
                       long long tpr) {
    if (++ch < n_ch) return;
    ch = 0;
    if (++rg < n_rg) return;
    rg = 0;
    s += ds;
    t += dt;
    if (t >= tpr) {
      t -= tpr;
      ++s;
    }
  }
};

template <bool VEC, int STAGES, int RUNS>
__global__ void __launch_bounds__(THREADS)
gf_apply_kernel(const uint8_t* __restrict__ mat,
                const uint8_t* __restrict__ mul,
                const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                int r, int k, long long n, long long stripes, int resident) {
  constexpr int TILE = THREADS * RUN * RUNS;
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                                  // [STAGES][KD][RUNS][THREADS]
  uint32_t* tab = reinterpret_cast<uint32_t*>(ring + STAGES * KD * RUNS * THREADS);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long tpr = (n + TILE - 1) / TILE;     // tiles per row
  const long long ds = gridDim.x / tpr, dt = gridDim.x % tpr;
  const int n_rg = (r + RB - 1) / RB;
  const int n_ch = (k + KD - 1) / KD;

  // start the loads of one chunk into ring slot `slot`
  auto fetch = [&](const Cursor& c, int slot) {
    if (c.s >= stripes) return;
    const long long s = c.s;
    const long long col = c.t * TILE + (long long)tid * RUN;
    const int j0 = c.ch * KD;
#pragma unroll
    for (int jj = 0; jj < KD; ++jj) {
      const int j = j0 + jj;
      if (j >= k) break;
      const uint8_t* row = data + (s * k + j) * n;
#pragma unroll
      for (int u = 0; u < RUNS; ++u) {
        const long long c0 = col + (long long)u * THREADS * RUN;
        uint4* dst = ring + ((slot * KD + jj) * RUNS + u) * THREADS + tid;
        if (VEC) {
          if (c0 < n) cp_async16(dst, row + c0);
        } else {
          uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (c0 + q * 4 + b < n)
                w[q] |= (uint32_t)row[c0 + q * 4 + b] << (8 * b);
          *dst = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
  };

  Cursor f{blockIdx.x / tpr, blockIdx.x % tpr, 0, 0};
  Cursor c = f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    fetch(f, s);
    cp_async_commit();
    f.next(n_rg, n_ch, ds, dt, tpr);
  }
  if (resident) {            // while the first chunks' loads fly
    stage_tables(tab, mat, mul, r, k, 0, n_rg, 0, k);
    __syncthreads();
  }
  int slot = 0, fslot = STAGES - 1;
  uint32_t acc[RUNS][16];
  while (c.s < stripes) {
    cp_async_wait<STAGES - 2>();      // this thread's chunk c has landed
    fetch(f, fslot);                  // into the slot chunk c-1 used
    cp_async_commit();
    f.next(n_rg, n_ch, ds, dt, tpr);
    fslot = fslot + 1 == STAGES ? 0 : fslot + 1;

    const int j0 = c.ch * KD;
    int tj0 = 0;                      // first data row of the staged slice
    if (!resident) {
      tj0 = (j0 / TAB_ROWS) * TAB_ROWS;
      if (j0 == tj0) {                // a new (tile, group, slice): re-stage
        __syncthreads();
        stage_tables(tab, mat, mul, r, k, c.rg, 1, tj0, min(TAB_ROWS, k - tj0));
        __syncthreads();
      }
    }
    if (c.ch == 0) {
#pragma unroll
      for (int u = 0; u < RUNS; ++u)
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[u][q] = 0;
    }
#pragma unroll
    for (int jj = 0; jj < KD; ++jj) {
      const int j = j0 + jj;
      if (j >= k) break;
      const int t = resident ? c.rg * k + j : j - tj0;
      const char* tb = reinterpret_cast<const char*>(tab) + t * TAB_BYTES + lane * 4;
#pragma unroll
      for (int u = 0; u < RUNS; ++u) {
        const uint4 x = ring[((slot * KD + jj) * RUNS + u) * THREADS + tid];
        const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const uint32_t b = (xw[q] >> (8 * p)) & 0xff;
            const uint32_t lo = *reinterpret_cast<const uint32_t*>(tb + ((b & 15) << 7));
            const uint32_t hi = *reinterpret_cast<const uint32_t*>(
                tb + TAB_BYTES / 2 + ((b >> 4) << 7));
            acc[u][q * 4 + p] ^= lo ^ hi;
          }
        }
      }
    }
    if (c.ch == n_ch - 1) {           // the group is done: transpose, store
      const long long s = c.s;
      const long long col = c.t * TILE + (long long)tid * RUN;
#pragma unroll
      for (int u = 0; u < RUNS; ++u) {
        const long long c0 = col + (long long)u * THREADS * RUN;
        if (c0 >= n) continue;
        // rw[q][c4]: output row 4g+q, columns 4*c4 .. 4*c4+3
        uint32_t rw[RB][4];
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const uint32_t a0 = acc[u][4 * c4], a1 = acc[u][4 * c4 + 1];
          const uint32_t a2 = acc[u][4 * c4 + 2], a3 = acc[u][4 * c4 + 3];
          const uint32_t l01 = __byte_perm(a0, a1, 0x5140);
          const uint32_t h01 = __byte_perm(a0, a1, 0x7362);
          const uint32_t l23 = __byte_perm(a2, a3, 0x5140);
          const uint32_t h23 = __byte_perm(a2, a3, 0x7362);
          rw[0][c4] = __byte_perm(l01, l23, 0x5410);
          rw[1][c4] = __byte_perm(l01, l23, 0x7632);
          rw[2][c4] = __byte_perm(h01, h23, 0x5410);
          rw[3][c4] = __byte_perm(h01, h23, 0x7632);
        }
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const int i = c.rg * RB + q;
          if (i >= r) break;
          uint8_t* orow = out + (s * r + i) * n + c0;
          if (VEC) {
            *reinterpret_cast<uint4*>(orow) =
                make_uint4(rw[q][0], rw[q][1], rw[q][2], rw[q][3]);
          } else {
#pragma unroll
            for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
              for (int b = 0; b < 4; ++b)
                if (c0 + c4 * 4 + b < n)
                  orow[c4 * 4 + b] = (uint8_t)(rw[q][c4] >> (8 * b));
          }
        }
      }
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    c.next(n_rg, n_ch, ds, dt, tpr);
  }
  cp_async_wait<0>();
}

template <bool VEC, int STAGES, int RUNS>
cudaError_t launch(const uint8_t* mat, const uint8_t* mul, const uint8_t* data,
                   uint8_t* out, int r, int k, long long n, long long stripes,
                   int blocks_per_sm, cudaStream_t stream) {
  auto kernel = gf_apply_kernel<VEC, STAGES, RUNS>;
  const int n_rg = (r + RB - 1) / RB;
  const int resident = n_rg * k <= TAB_ROWS;
  const int tables = resident ? n_rg * k : (k < TAB_ROWS ? k : TAB_ROWS);
  const size_t smem = (size_t)STAGES * KD * RUNS * THREADS * sizeof(uint4) +
                      (size_t)tables * TAB_BYTES;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0, fit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &fit, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  // a named block count the SM cannot hold is refused, not cut down
  if (fit < 1 || blocks_per_sm > fit) return cudaErrorInvalidConfiguration;
  const int per_sm = blocks_per_sm > 0 ? blocks_per_sm : fit;
  constexpr int TILE = THREADS * RUN * RUNS;
  const long long tiles = stripes * ((n + TILE - 1) / TILE);
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(tiles < cap ? tiles : cap);
  kernel<<<grid, THREADS, smem, stream>>>(mat, mul, data, out, r, k, n,
                                          stripes, resident);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(const uint8_t* mat, const uint8_t* mul,
                     const uint8_t* data, uint8_t* out, int r, int k,
                     long long n, long long stripes, int stages, int runs,
                     int blocks_per_sm, cudaStream_t s) {
#define GF_CASE(S, U)                                                      \
  if (stages == S && runs == U)                                            \
    return launch<VEC, S, U>(mat, mul, data, out, r, k, n, stripes,        \
                             blocks_per_sm, s);
  GF_CASE(2, 1) GF_CASE(3, 1) GF_CASE(4, 1) GF_CASE(6, 1)
  GF_CASE(2, 2) GF_CASE(3, 2) GF_CASE(4, 2)
#undef GF_CASE
  return cudaErrorInvalidValue;
}

int run(const void* mat, const void* mul, const void* data, void* out, int r,
        int k, long long n, long long stripes, int stages, int runs,
        int blocks_per_sm, void* stream) {
  if (r < 1 || k < 1 || n < 1 || stripes < 1) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)data % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   (n % 16 == 0);
  const auto* m = static_cast<const uint8_t*>(mat);
  const auto* t = static_cast<const uint8_t*>(mul);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? dispatch<true>(m, t, d, o, r, k, n, stripes, stages, runs,
                                    blocks_per_sm, s)
                   : dispatch<false>(m, t, d, o, r, k, n, stripes, stages,
                                     runs, blocks_per_sm, s));
}

}  // namespace

extern "C" {

// Vertical layout: data [stripes*k, n] -> out [stripes*r, n]; stripe s
// reads rows [s*k, (s+1)*k) and writes rows [s*r, (s+1)*r).  stripes = 1
// is the plain out[r, n] = mat[r, k] ·GF data[k, n].  mul is the device
// copy of the 256x256 GF(2^8) product table.  Returns the cudaError_t of
// the launch.
int gf_apply_launch(const void* mat, const void* mul, const void* data,
                    void* out, int r, int k, long long n, long long stripes,
                    void* stream) {
  return run(mat, mul, data, out, r, k, n, stripes, DEFAULT_STAGES,
             DEFAULT_RUNS, 0, stream);
}

// The same apply with the launch variant named: ring depth `stages`
// (2, 3, 4 or 6), 16-byte runs per thread `runs` (1 or 2; 2 only with
// stages <= 4) and `blocks_per_sm` (0: as many as fit; more than fit is
// refused with cudaErrorInvalidConfiguration).  For the
// sweep_stripes tool only; gf_apply_launch is what the port runs.
int gf_apply_variant_launch(const void* mat, const void* mul,
                            const void* data, void* out, int r, int k,
                            long long n, long long stripes, int stages,
                            int runs, int blocks_per_sm, void* stream) {
  return run(mat, mul, data, out, r, k, n, stripes, stages, runs,
             blocks_per_sm, stream);
}

}  // extern "C"
