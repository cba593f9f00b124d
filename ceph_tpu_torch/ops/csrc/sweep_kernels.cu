// The kernels of the kernel sweep on Hopper (sm_90a): the GF(2^8) apply
// through a bit-plane product on the tensor cores, and a pure-stream copy.
//
// Replaces three TPU kernels of tools/kernel_sweep.py:
//   make_v1 / _kernel_v1   (:84 / :55)   bitplane_apply_launch, groups = 1
//   make_bd / _kernel_bd   (:142 / :95)  bitplane_apply_launch, groups = G
//   make_copy / _copy_kernel (:164 / :154)  copy_rows_launch
//
// bitplane_apply_launch: out[r, N] = mat ·GF(2^8) data[k, N], given the
// plane-major bit-matrix of mat (B[b*r + i, bj*k + j] = bit b of
// mat[i, j]·2^bj), or with groups = G the block-diagonal [G*8r, G*8k]
// stack of it.  Per column: unpack the k data bytes to 8k bits, take the
// GF(2) product with B (integer sums, then & 1), pack bit b of output row
// i from product row b*r + i.  With G groups the columns are taken in
// spans of G column tiles of tile_n columns, and column c of every tile of
// a span is one stacked column: its G*8k bits meet the whole
// block-diagonal operand, as _kernel_bd does; unlike it, every column of
// the one output [r, N] is written, and a ragged N is masked.
//
// What bounds it on this card: device-memory bytes ((k + r) * N at
// 3.35 TB/s) for the int8 product at G = 1; the tensor-core operations
// (2 * G*8r * G*8k * N/G at the dense peak) for bf16 and for the
// block-diagonal stacks.  At [4, 8] x [8, 8 Mi] the int8 bound is 0.030
// ms: with 132 SMs x 4 schedulers at ~1.98 GHz that leaves about 3.7
// warp instructions per column for everything around the product.
//
// What held the first design back (the bit-plane operand as mma.sync's B,
// built per lane from bytes staged column-major; the 0/1 bit-matrix as A
// in shared memory; one output bit per accumulator row, repacked bit by
// bit; 256-thread blocks, one per 8192-column tile, waiting on their own
// staging loads between sub-tiles): about a dozen warp instructions per
// column and no prefetch, 14% and 11% of the int8 and bf16 bounds at
// G = 1, 13-17% at G = 2 and 4 (PERF.md; NVIDIA H100 80GB HBM3, 700 W).
//
// This design, chosen by measurement on the card (PERF.md):
//   - the product is swapped: out^T[N, 8U] = bits^T[N, 8*G*kp] . B^T,
//     U = G*r stacked output rows.  Data columns are the M rows of
//     mma.sync m16n8k32 (s8) or m16n8k16 (bf16); the bit-plane operand is
//     A and lives only in registers.  A warp tile is 64 columns, 4 M
//     tiles; lane (gid, tig)'s A rows, gid and gid+8 of each M tile, are
//     columns 32*(t/2) + 4*gid + 2*(t%2) + h: two runs of 4 adjacent
//     columns, so 4 row words of the staged tile and one 4x4 __byte_perm
//     transpose give a run's 4 column words, and a register's 4 (s8) or
//     2 (bf16) K values, one plane of 4 or 2 adjacent data rows, are
//     (word >> plane) & 0x01010101 (bf16: two bytes widened by one
//     __byte_perm and a multiply by 0x3F80).  Column words are reloaded
//     only when a fragment needs other data rows: at k = 8 once a tile;
//   - the output bits are ordered n = 32*(u/4) + 8*(b/2) + 2*(u%4) + b%2
//     (bit b of stacked row u), so a lane's accumulators (n = 8m + 2tig +
//     {0, 1}) hold all 8 bits of row 4*(n/32) + tig for its 8 columns: 3
//     __byte_perm gather 4 columns' low bytes per bit (bf16: after adding
//     2^23, which puts the count's bits in the float's low mantissa),
//     and the lane stores whole words, with no shuffle.  N runs in passes
//     of 32 (4 n-tiles, 64 accumulators);
//   - the coefficient operand B is built once per block in shared memory
//     as ready mma fragments, one 8-byte word per lane, or where that
//     exceeds 32 KiB as one byte per lane expanded by a multiply
//     (0x00204081 spreads a nibble into 4 bytes) at use;
//   - warps are independent: each has its own 3-stage cp.async ring of
//     warp tiles (rows padded to 80 bytes, so rows 4 apart start 16 banks
//     apart) and walks the tiles t = warp, + all warps, ... of a
//     persistent grid; only __syncwarp orders a ring.  Every copy and
//     store index is computed once per block;
//   - tried and measured slower on the card: wgmma (m64nNk32 / k16, A from
//     registers, B through a shared-memory descriptor), the warpgroup
//     waiting on each product and ptxas inserting warpgroup arrives
//     around the register operands; and 3-stage rings shared by a block,
//     whose barrier per sub-tile held every warp to the slowest.  Deeper
//     rings (5, 8 stages) changed nothing, and more warps an SM (32-column
//     warp tiles, register caps) ran slower: the time is the instruction
//     stream's latency at 16 warps an SM (124-127 registers), not loads;
//   - int8 (s8 x s8 -> s32) and bf16 (-> f32) stay exact: the terms are
//     0/1 and a sum is at most 8*G*k;
//   - for groups > 1 the whole block-diagonal operand is multiplied,
//     zeros and all, as _kernel_bd does; unlike it, every column of the one
//     output [r, N] is written, and a ragged N is masked.
// Limits (the wrapper raises first): G*r <= 32, G*kp <= 64, tile_n a
// multiple of 256.
//
// copy_rows_launch: out[r, N] = data[:r].  It reads every byte of all k
// rows, as the TPU kernel's BlockSpec((k, tile_n)) does, and writes r rows:
// the ceiling for the (k + r) * N traffic of a GF apply.  Bound by bytes
// ((k + r) * N at 3.35 TB/s: 0.0300 ms at [8, 8 Mi], r = 4).
//
// What held the first design back (a block of 256 threads per tile_n
// columns, each thread a register-staged 16-byte __ldg per row with the
// store of each of the first r rows right behind its load, the unused
// rows' loads kept alive by an XOR fold stored through a null pointer):
// 1,024 short-lived blocks at [8, 8 Mi], each exposing its own ramp and
// drain, loads and stores interleaved; 0.03884 ms, 77% of the bound and
// 1.50x the time of data[:4].clone() (PERF.md).
//
// This design, a persistent TMA bulk-copy ring (cp.async.bulk, 1-D, no
// tensor map), chosen by measurement on the card (PERF.md):
//   - a persistent grid of one-warp blocks, as many as the shared memory
//     holds (two an SM); block b takes the spans of tile_n columns b,
//     b + grid, ...: tile_n is the unit of work of one turn, not the stage
//     width;
//   - a stage is a [kb, W] byte tile in dynamic shared memory of about
//     COPY_STAGE_BYTES: W = 32 KiB / k rounded down to 16 (4 KiB at
//     k = 8) and kb = k rows, or where that W is under COPY_W_MIN, row
//     blocks of kb = 16 rows of 2 KiB (k = 64, 128): a bulk copy of
//     256-512 bytes costs the copy unit about what one of 2 KiB does, and
//     such rows ran the ring at half the rate; W is at most tile_n;
//     COPY_STAGES stages form the ring;
//   - one warp plays both roles in order: lane 0 arms a stage's mbarrier
//     with expect_tx of kb * w bytes and the lanes issue one bulk load a
//     row (lane l rows l, l + 32, ...); when the stage's phase completes
//     they issue one bulk store a row of rows 0..r-1 (bulk_group, one
//     commit a stage and lane), and refill the stage before it once every
//     lane's wait_group.read 1 shows that stage's stores have read it, so
//     the stores of one stage overlap the wait for the next;
//   - rows r..k-1 land in shared memory and are never stored: a bulk load
//     is not dropped by the compiler, so they need no sink;
//   - bulk copies need 16-byte aligned addresses and sizes: an unaligned
//     data or out, or N % 16 != 0, takes the byte path
//     (copy_rows_bytes_kernel: a block per tile_n columns, byte loads, the
//     unused rows XOR-folded into a store through a null pointer so that
//     nvcc keeps their loads).  A last span shorter than tile_n, still a
//     multiple of 16, goes as shorter bulk copies;
//   - the item walk advances by additions: a 64-bit division is a call,
//     and with one per item the ring ran some 2% slower;
//   - measured no faster and left out: deeper rings (4-6 stages) at one
//     block an SM (slower at k = 128), 48-64 KiB stages (6-8 KiB rows at
//     k = 8), 16 KiB stages at three blocks an SM, and an evict-first L2
//     policy on the copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 256;        // copy_rows_bytes_kernel
constexpr int TC = 256;             // tile_n quantum
constexpr int COPY_STAGES = 3;      // copy ring: stages
constexpr int COPY_STAGE_BYTES = 32 * 1024;   // bytes of one [kb, W] stage
constexpr int COPY_W_MIN = 2048;    // narrowest stage row (but for a
                                    // narrow tile_n or stage)
constexpr int COPY_ALIGN = 128;     // stage base alignment in shared memory
constexpr int COPY_BARS =           // the ring's mbarriers, then its stages
    (8 * COPY_STAGES + COPY_ALIGN - 1) / COPY_ALIGN * COPY_ALIGN;
constexpr int COPY_SMEM_MAX = COPY_BARS + COPY_STAGES * COPY_STAGE_BYTES;

constexpr int BP_THREADS = 128;     // 4 warps, each on its own columns
constexpr int WPB = BP_THREADS / 32;
constexpr int WC = 64;              // columns of one warp tile: 4 M tiles
constexpr int WRS = WC + 16;        // ring row stride: rows 4 apart start
                                    // 16 banks apart
constexpr int BP_STAGES = 3;        // cp.async ring depth of a warp
constexpr int NP = 32;              // output bits of one pass: 4 n-tiles
constexpr int NT = NP / 8;
constexpr int FULL_B_MAX = 32 * 1024;   // B fragments kept whole up to this

template <bool BF16> struct AccType { using T = int; };
template <> struct AccType<true> { using T = float; };

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

__device__ __forceinline__ void mma(int* c, const uint32_t* a, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// low bit of an accumulator (an integral count) in the low byte
__device__ __forceinline__ uint32_t low_word(int x) { return (uint32_t)x; }
__device__ __forceinline__ uint32_t low_word(float x) {
  return __float_as_uint(x + 8388608.0f);   // 2^23: the count's bits
}

// the low bits of 4 accumulators (4 adjacent columns) as bytes 0 or 1
template <typename Acc>
__device__ __forceinline__ uint32_t lsb4(Acc c0, Acc c1, Acc c2, Acc c3) {
  const uint32_t p01 = __byte_perm(low_word(c0), low_word(c1), 0x0040);
  const uint32_t p23 = __byte_perm(low_word(c2), low_word(c3), 0x0040);
  return __byte_perm(p01, p23, 0x5410) & 0x01010101u;
}

// a B fragment from its compact byte: s8, two nibbles of 4 K values;
// bf16, two pairs of 2 K values
template <bool BF16>
__device__ __forceinline__ uint2 expand_b(uint32_t x) {
  if (BF16)
    return make_uint2(((x & 1u) | ((x & 2u) << 15)) * 0x3F80u,
                      (((x >> 2) & 1u) | ((x & 8u) << 13)) * 0x3F80u);
  return make_uint2(((x & 15u) * 0x00204081u) & 0x01010101u,
                    (((x >> 4) & 15u) * 0x00204081u) & 0x01010101u);
}

template <bool BF16, bool COMPACT>
__global__ void __launch_bounds__(BP_THREADS)
bitplane_kernel(const uint8_t* __restrict__ bmat,
                const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                int r, int k, long long n, int G, long long tile_n, int kp,
                int npass, bool vec16, bool vec4) {
  using Acc = typename AccType<BF16>::T;
  constexpr int KSTEP = BF16 ? 16 : 32;            // K of one mma
  extern __shared__ __align__(16) uint8_t smem[];
  const int gkp = G * kp;                          // data bytes of a column
  const int K = 8 * gkp;                           // product depth
  const int ksteps = K / KSTEP;
  const int units = G * r;                         // stacked output rows
  const int frags = npass * ksteps * NT * 32;      // B fragments, all passes
  const int pieces = G * k * (WC / 16);            // 16-B copies a warp tile
  // layout: B fragments | kinfo [K/4] | urow, ucol [32] | piece table |
  // the warps' rings
  uint8_t* B_s = smem;
  uint32_t* kinfo = reinterpret_cast<uint32_t*>(
      smem + (((size_t)frags * (COMPACT ? 1 : 8) + 15) & ~(size_t)15));
  long long* urow = reinterpret_cast<long long*>(kinfo + K / 4);
  long long* ucol = urow + 32;
  long long* pcol = ucol + 32;                     // [pieces]
  int* pdst = reinterpret_cast<int*>(pcol + pieces);
  int* prow = pdst + pieces;
  uint8_t* rings = reinterpret_cast<uint8_t*>(prow + pieces);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  uint8_t* ring = rings + warp * BP_STAGES * gkp * WRS;

  // B[kk][n]: kk = g*8kp + plane*kp + j (bit `plane` of data row j of
  // group g); n = 32*(u/4) + 8*(b/2) + 2*(u%4) + b%2 (bit b of stacked
  // output row u = g*r + i), so lane tig's accumulators hold all 8 bits of
  // rows 4m + tig.  Fragment (pass, ks, nt, lane) = the mma B fragment.
  auto coef = [&](int kk, int nn) -> uint32_t {
    const int w32 = nn & 31;
    const int u = 4 * (nn >> 5) + ((w32 & 7) >> 1);
    const int bo = 2 * (w32 >> 3) + (w32 & 1);
    const int gi = kk / (8 * kp), rem = kk % (8 * kp);
    const int bi = rem / kp, j = rem % kp;
    if (u >= units || j >= k) return 0;
    return bmat[(long long)((u / r) * 8 * r + bo * r + u % r) * (G * 8 * k) +
                gi * 8 * k + bi * k + j] & 1;
  };
  for (int e = threadIdx.x; e < frags; e += BP_THREADS) {
    const int ln = e & 31, nt = (e >> 5) % NT, ks = (e >> 5) / NT % ksteps;
    const int p = (e >> 5) / NT / ksteps;
    const int nn = p * NP + nt * 8 + (ln >> 2), t4 = ln & 3;
    uint32_t w[2] = {0, 0}, bits = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int per = BF16 ? 2 : 4;
      const int kk = KSTEP * ks + h * (KSTEP / 2) + per * t4;
      for (int y = 0; y < per; ++y) {
        const uint32_t c = coef(kk + y, nn);
        bits |= c << (h * per + y);
        w[h] |= BF16 ? (c ? 0x3F80u : 0u) << (16 * y) : c << (8 * y);
      }
    }
    if (COMPACT)
      B_s[e] = (uint8_t)bits;
    else
      reinterpret_cast<uint2*>(B_s)[e] = make_uint2(w[0], w[1]);
  }
  // per 4 K values: (plane << 16) | ring row of their first data row
  for (int c = threadIdx.x; c < K / 4; c += BP_THREADS) {
    const int kk = 4 * c, gi = kk / (8 * kp), rem = kk % (8 * kp);
    kinfo[c] = ((uint32_t)(rem / kp) << 16) | (uint32_t)(gi * kp + rem % kp);
  }
  // stacked output row u = g*r + i: row i's offset in out and group g's
  // first column from the span's
  if (threadIdx.x < units) {
    urow[threadIdx.x] = (long long)(threadIdx.x % r) * n;
    ucol[threadIdx.x] = (long long)(threadIdx.x / r) * tile_n;
  }
  // the 16-byte copies of a warp tile: piece q copies data row j of group
  // g, bytes 16*cq .. of the tile, to ring row g*kp + j
  for (int q = threadIdx.x; q < pieces; q += BP_THREADS) {
    const int cq = q % (WC / 16), j = q / (WC / 16) % k;
    const int g = q / (WC / 16) / k;
    pdst[q] = (g * kp + j) * WRS + cq * 16;
    prow[q] = j;
    pcol[q] = g * tile_n + cq * 16;
  }
  // data rows k..kp-1 of each group are never loaded: zero them once
  for (int e = threadIdx.x; e < WPB * BP_STAGES * gkp * WRS; e += BP_THREADS)
    if ((e / WRS) % gkp % kp >= k) rings[e] = 0;
  __syncthreads();

  // warp tiles: tile t = (span unit t / per_unit, tile t % per_unit) of
  // WC columns of every group; warps take t = gw, gw + nw, ...  Tiles
  // wholly past n come only at the end of a warp's sequence.
  const long long span = (long long)G * tile_n;
  const long long per_unit = tile_n / WC;
  const long long nw = (long long)gridDim.x * WPB;
  const long long gw = (long long)blockIdx.x * WPB + warp;
  const long long d_unit = nw / per_unit, d_st = nw % per_unit;
  struct Cursor {
    long long unit, st;
  };
  auto advance = [&](Cursor& c) {
    c.unit += d_unit;
    c.st += d_st;
    if (c.st >= per_unit) {
      c.st -= per_unit;
      ++c.unit;
    }
  };
  auto first_col = [&](const Cursor& c) { return c.unit * span + c.st * WC; };
  Cursor cur{gw / per_unit, gw % per_unit}, pf = cur;
  int pf_slot = 0, slot = 0;
  auto stage_next = [&]() {
    const long long col0 = first_col(pf);
    if (col0 < n) {
      uint8_t* dst0 = ring + pf_slot * gkp * WRS;
      for (int q = lane; q < pieces; q += 32) {
        const long long col = col0 + pcol[q];
        const uint8_t* src = data + (long long)prow[q] * n + col;
        uint8_t* dst = dst0 + pdst[q];
        if (vec16 && col + 16 <= n) {
          cp_async16(dst, src);
        } else {
          uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
          for (int y = 0; y < 16; ++y)
            if (col + y < n)
              w[y >> 2] |= (uint32_t)__ldg(src + y) << (8 * (y & 3));
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      advance(pf);
    }
    pf_slot = pf_slot + 1 == BP_STAGES ? 0 : pf_slot + 1;
    cp_async_commit();
  };
  for (int s = 0; s < BP_STAGES - 1; ++s) stage_next();

  // M tile t, row gid + 8h <-> column 32*(t/2) + 4*gid + 2*(t%2) + h: the
  // lane's 8 columns are two runs of 4, read as 4 row words each
#pragma unroll 1
  for (; first_col(cur) < n; advance(cur)) {
    cp_async_wait<BP_STAGES - 2>();
    __syncwarp();                     // the tile landed; slot-1 is free
    stage_next();
    const uint8_t* tile = ring + slot * gkp * WRS + 4 * gid;
    slot = slot + 1 == BP_STAGES ? 0 : slot + 1;
    const long long col0 = first_col(cur) + 4 * gid;
#pragma unroll 1
    for (int p = 0; p < npass; ++p) {
      Acc acc[4][NT][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int x = 0; x < NT; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[t][x][y] = 0;
      uint32_t cw[2][4];            // column words of the two runs
      int row = -1;
#pragma unroll 1
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t a[4][4];
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) {
          const int kk0 = KSTEP * ks + c2 * (KSTEP / 2) + (BF16 ? 2 : 4) * tig;
          const uint32_t e = kinfo[kk0 >> 2];
          const int need = (int)(e & 0xFFFF);
          if (need != row) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const uint8_t* src = tile + need * WRS + 32 * half;
              const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
              const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + WRS);
              const uint32_t r2 = *reinterpret_cast<const uint32_t*>(src + 2 * WRS);
              const uint32_t r3 = *reinterpret_cast<const uint32_t*>(src + 3 * WRS);
              const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
              const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
              const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
              const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
              cw[half][0] = __byte_perm(t0, t2, 0x5410);
              cw[half][1] = __byte_perm(t0, t2, 0x7632);
              cw[half][2] = __byte_perm(t1, t3, 0x5410);
              cw[half][3] = __byte_perm(t1, t3, 0x7632);
            }
            row = need;
          }
          const uint32_t sh = (e >> 16) + (BF16 ? 8 * (kk0 & 3) : 0);
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t w = cw[t >> 1][2 * (t & 1) + h];
              if (BF16) {
                const uint32_t x = (w >> sh) & 0x0101u;
                a[t][2 * c2 + h] = __byte_perm(x, 0, 0x4140) * 0x3F80u;
              } else {
                a[t][2 * c2 + h] = (w >> sh) & 0x01010101u;
              }
            }
        }
        const int f0 = ((p * ksteps + ks) * NT) * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 b = COMPACT ? expand_b<BF16>(B_s[f0 + nt * 32])
                                  : reinterpret_cast<const uint2*>(B_s)[f0 + nt * 32];
#pragma unroll
          for (int t = 0; t < 4; ++t) mma(acc[t][nt], a[t], b);
        }
      }
      // acc[t][nt][2h + e]: column of (t, h), bit 2*nt + e of stacked
      // output row u = 4p + tig: the words of the lane's two runs of 4
      const int u = 4 * p + tig;
      if (u < units) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t v = 0;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const Acc* lo = acc[2 * half][b >> 1];
            const Acc* hi = acc[2 * half + 1][b >> 1];
            const int e = b & 1;
            v |= lsb4(lo[e], lo[2 + e], hi[e], hi[2 + e]) << b;
          }
          const long long col = col0 + 32 * half + ucol[u];
          uint8_t* dst = out + urow[u] + col;
          if (vec4 && col + 4 <= n) {
            *reinterpret_cast<uint32_t*>(dst) = v;
          } else {
#pragma unroll
            for (int x = 0; x < 4; ++x)
              if (col + x < n) dst[x] = (uint8_t)(v >> (8 * x));
          }
        }
      }
    }
    __syncwarp();                     // reads of this slot end here
  }
  cp_async_wait<0>();
}

template <bool BF16, bool COMPACT>
cudaError_t launch_bitplane(const uint8_t* bmat, const uint8_t* data,
                            uint8_t* out, int r, int k, long long n, int G,
                            long long tile_n, int kp, int npass,
                            size_t smem, cudaStream_t stream) {
  cudaError_t err;
  int dev = 0, optin = 0, sms = 0, fit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bitplane_kernel<BF16, COMPACT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &fit, bitplane_kernel<BF16, COMPACT>, BP_THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  // a persistent grid: as many blocks as fit, or one warp per warp tile
  const long long tiles = (n + WC - 1) / WC;
  const long long cap = (long long)sms * fit;
  const long long want = (tiles + WPB - 1) / WPB;
  const int blocks = (int)(want < cap ? want : cap);
  const bool vec16 = ((uintptr_t)data % 16 == 0) && (n % 16 == 0);
  const bool vec4 = ((uintptr_t)out % 4 == 0) && (n % 4 == 0);
  bitplane_kernel<BF16, COMPACT><<<blocks, BP_THREADS, smem, stream>>>(
      bmat, data, out, r, k, n, G, tile_n, kp, npass, vec16, vec4);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_b(int r, int k, long long n, int G, long long tile_n,
                       const uint8_t* bmat, const uint8_t* data, uint8_t* out,
                       cudaStream_t s) {
  const int kp = (k + 3) / 4 * 4, gkp = G * kp, K = 8 * gkp;
  int rows = 4;                 // stacked output rows: a power of two >= 4
  while (rows < G * r) rows *= 2;
  const int npass = rows / 4;
  const size_t frags = (size_t)npass * (K / (BF16 ? 16 : 32)) * NT * 32;
  const bool compact = frags * 8 > (size_t)FULL_B_MAX;
  const size_t pieces = (size_t)G * k * (WC / 16);
  const size_t smem = ((frags * (compact ? 1 : 8) + 15) & ~(size_t)15) + K +
                      64 * sizeof(long long) + pieces * 16 +
                      (size_t)WPB * BP_STAGES * gkp * WRS;
  return compact ? launch_bitplane<BF16, true>(bmat, data, out, r, k, n, G,
                                               tile_n, kp, npass, smem, s)
                 : launch_bitplane<BF16, false>(bmat, data, out, r, k, n, G,
                                                tile_n, kp, npass, smem, s);
}

// -- copy_rows ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// true once the phase of parity `parity` has completed
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every committed store group but the newest N has read its shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// the ring's geometry, fixed by the launcher
struct CopyPlan {
  long long n, tile_n, spans;
  int r, k;
  int w;              // stage row bytes: a multiple of 16, <= tile_n
  int kb;             // rows a stage holds
  int stride;          // bytes between stage bases
};

// A walk over this block's items in order: the spans blockIdx.x,
// + gridDim.x, ..., each in chunks of w columns, each in row blocks of
// kb rows.  Advanced by additions only: a 64-bit division costs a call.
struct CopyCursor {
  long long span, c0, end;   // span, its chunk's first column, span end
  int j0;                    // the row block's first row

  __device__ explicit CopyCursor(const CopyPlan& p)
      : span(blockIdx.x), c0(span * p.tile_n),
        end(min(p.n, c0 + p.tile_n)), j0(0) {}
  __device__ bool valid(const CopyPlan& p) const { return span < p.spans; }
  __device__ int width(const CopyPlan& p) const {
    return (int)min((long long)p.w, end - c0);
  }
  __device__ int rows(const CopyPlan& p) const { return min(p.kb, p.k - j0); }
  __device__ void next(const CopyPlan& p) {
    if ((j0 += p.kb) < p.k) return;
    j0 = 0;
    if ((c0 += p.w) < end) return;
    span += gridDim.x;
    c0 = span * p.tile_n;
    end = min(p.n, c0 + p.tile_n);
  }
};

__global__ void __launch_bounds__(32)
copy_rows_ring_kernel(const uint8_t* __restrict__ data,
                      uint8_t* __restrict__ out, const CopyPlan p) {
  extern __shared__ __align__(COPY_ALIGN) uint8_t ring_smem[];
  const int lane = threadIdx.x;
  const uint32_t bars = smem_u32(ring_smem);
  const uint32_t ring = bars + COPY_BARS;
  if (lane == 0) {
    for (int s = 0; s < COPY_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // lane 0 arms stage s; each lane loads rows lane, lane + 32, ... of the
  // loader's item, which then moves on
  CopyCursor ld(p), st(p);
  auto load = [&](int s) {
    const int w = ld.width(p), rows = ld.rows(p);
    const uint32_t bar = bars + 8 * s, dst = ring + s * p.stride;
    if (lane == 0) mbar_expect_tx(bar, (uint32_t)(rows * w));
    const uint8_t* src = data + (long long)ld.j0 * p.n + ld.c0;
    for (int j = lane; j < rows; j += 32)
      bulk_load(dst + j * p.w, src + (long long)j * p.n, w, bar);
    ld.next(p);
  };

  for (int s = 0; s < COPY_STAGES && ld.valid(p); ++s) load(s);
  // item t sits in stage t % stages, in that stage's phase t / stages
  for (int s = 0, prev = -1, phase = 0; st.valid(p);) {
    while (!mbar_try_wait(bars + 8 * s, (uint32_t)phase)) {
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int w = st.width(p), stored = min(st.rows(p), p.r - st.j0);
    const uint32_t src = ring + s * p.stride;
    for (int j = lane; j < stored; j += 32)
      bulk_store(out + (long long)(st.j0 + j) * p.n + st.c0, src + j * p.w,
                 w);
    bulk_commit();
    st.next(p);
    // refill the stage before this one once every lane's stores have
    // read it (a bulk group is the issuing thread's own)
    if (prev >= 0 && ld.valid(p)) {
      bulk_wait_read<1>();
      __syncwarp();
      load(prev);
    }
    prev = s;
    if (++s == COPY_STAGES) s = 0, phase ^= 1;
  }
  bulk_wait_read<0>();
}

__global__ void __launch_bounds__(THREADS)
copy_rows_bytes_kernel(const uint8_t* __restrict__ data,
                       uint8_t* __restrict__ out, int r, int k, long long n,
                       long long tile_n, uint32_t* sink_out) {
  const long long base = (long long)blockIdx.x * tile_n;
  uint32_t sink = 0;
  for (long long c = (long long)threadIdx.x * 16; c < tile_n; c += THREADS * 16) {
    const long long col = base + c;
    if (col >= n) break;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const uint8_t* src = data + (long long)j * n + col;
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int x = 0; x < 16; ++x)
        if (col + x < n) w[x / 4] |= (uint32_t)__ldg(src + x) << (8 * (x % 4));
      if (j < r) {
        uint8_t* dst = out + (long long)j * n + col;
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (col + x < n) dst[x] = (uint8_t)(w[x / 4] >> (8 * (x % 4)));
      } else {
        sink ^= w[0] ^ w[1] ^ w[2] ^ w[3];
      }
    }
  }
  if (sink_out != nullptr) atomicXor(sink_out, sink);
}

// The current device's SM count and how many ring blocks of `smem` bytes
// an SM holds.  The stage shape, and with it `smem`, follows k and tile_n.
// The answers are kept per device, so that a launch makes no driver query.
cudaError_t ring_fit(size_t smem, int* sms, int* fit) {
  struct Known { int sms = 0; size_t smem = 0; int fit = 0; };
  static Known known[64];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  Known& k = known[dev];
  if (k.sms == 0) {
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             copy_rows_ring_kernel,
             cudaFuncAttributeMaxDynamicSharedMemorySize, COPY_SMEM_MAX)) !=
            cudaSuccess)
      return err;
    k.sms = n;
  }
  if (k.smem != smem) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &k.fit, copy_rows_ring_kernel, 32, smem)) != cudaSuccess)
      return err;
    k.smem = smem;
  }
  *sms = k.sms;
  *fit = k.fit;
  return cudaSuccess;
}

// a grid of as many ring blocks as the SMs hold, at most one a span; a
// ring no SM can hold is refused
cudaError_t launch_copy_ring(const uint8_t* data, uint8_t* out, int r, int k,
                             long long n, long long tile_n,
                             cudaStream_t stream) {
  CopyPlan p;
  p.n = n;
  p.tile_n = tile_n;
  p.spans = (n + tile_n - 1) / tile_n;
  p.r = r;
  p.k = k;
  long long w = (long long)(COPY_STAGE_BYTES / k) / 16 * 16;
  w = w < COPY_W_MIN ? COPY_W_MIN : w;
  p.w = (int)(w < tile_n ? w : tile_n);
  p.kb = COPY_STAGE_BYTES / p.w < k ? COPY_STAGE_BYTES / p.w : k;
  p.stride = (p.kb * p.w + COPY_ALIGN - 1) / COPY_ALIGN * COPY_ALIGN;
  const size_t smem = (size_t)COPY_BARS + (size_t)COPY_STAGES * p.stride;
  int sms = 0, fit = 0;
  const cudaError_t err = ring_fit(smem, &sms, &fit);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)sms * fit;
  const int grid = (int)(p.spans < cap ? p.spans : cap);
  copy_rows_ring_kernel<<<grid, 32, smem, stream>>>(data, out, p);
  return cudaGetLastError();
}

cudaError_t launch_copy_bytes(const uint8_t* data, uint8_t* out, int r, int k,
                              long long n, long long tile_n,
                              cudaStream_t stream) {
  const long long blocks = (n + tile_n - 1) / tile_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  copy_rows_bytes_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      data, out, r, k, n, tile_n, nullptr);
  return cudaGetLastError();
}

bool copy_args_ok(int r, int k, long long n, long long tile_n) {
  return r >= 1 && k >= r && n >= 1 && tile_n >= TC && tile_n % TC == 0;
}

bool bulk_ok(const void* data, const void* out, long long n) {
  return (uintptr_t)data % 16 == 0 && (uintptr_t)out % 16 == 0 &&
         n % 16 == 0;
}

}  // namespace

extern "C" {

// out [r, n] = mat ·GF(2^8) data [k, n] through the plane-major bit-matrix
// bmat [groups*8r, groups*8k] (0/1 bytes; bit 0 is read), block-diagonal
// for groups > 1.  acc: 0 = int8 (m16n8k32), 1 = bf16 (m16n8k16).
// Columns are stacked in spans of groups tiles of tile_n.  Requires
// groups*r <= 32, groups*round_up(k, 4) <= 64 and tile_n a positive
// multiple of 256.  Launches on `stream`, allocates nothing, returns the
// cudaError_t.
int bitplane_apply_launch(const void* bmat, const void* data, void* out,
                          int r, int k, long long n, int groups,
                          long long tile_n, int acc, void* stream) {
  const int kp = (k + 3) / 4 * 4;
  if (r < 1 || k < 1 || n < 1 || groups < 1 || groups * r > 32 ||
      groups * kp > 64 || tile_n < TC || tile_n % TC != 0 ||
      (acc != 0 && acc != 1))
    return (int)cudaErrorInvalidValue;
  const auto* b = static_cast<const uint8_t*>(bmat);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(acc == 1 ? dispatch_b<true>(r, k, n, groups, tile_n, b, d, o, s)
                        : dispatch_b<false>(r, k, n, groups, tile_n, b, d, o, s));
}

// out [r, n] = data [:r] of data [k, n], reading all k rows; a block takes
// tile_n columns (a positive multiple of 256) a turn.  The bulk-copy ring
// where data, out and n are 16-byte aligned, the byte path otherwise.
// Returns the cudaError_t.
int copy_rows_launch(const void* data, void* out, int r, int k, long long n,
                     long long tile_n, void* stream) {
  if (!copy_args_ok(r, k, n, tile_n)) return (int)cudaErrorInvalidValue;
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(bulk_ok(data, out, n)
                   ? launch_copy_ring(d, o, r, k, n, tile_n, s)
                   : launch_copy_bytes(d, o, r, k, n, tile_n, s));
}

}  // extern "C"
