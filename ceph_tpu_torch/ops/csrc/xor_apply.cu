// GF(2) bitmatrix apply on Hopper (sm_90a):
//   out[r, :] = XOR of packets[i, :] over the i with W[r, i] & 1,
// W [R, K] 0/1 bytes, packets [K, P] bytes, out [R, P] bytes.
//
// Replaces the TPU kernel xor_apply_pallas / _xor_kernel of
// ceph_tpu/ops/pallas_kernels.py:207 / :197 (its body is
// rs_kernels.bitplane_xor_matmul): the data path of the jerasure bitmatrix
// techniques (liberation, blaum_roth, liber8tion) and of the w=16/32
// wide-word codes, W = [m*w, k*w] for encode, [lost*w, k*w] for decode.
// The TPU kernel unpacks each byte into 8 bit-planes for an int8 MXU
// matmul mod 2; here bytes stay bytes and one 32-bit XOR does four
// byte-XORs.
//
// Times below: NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md).
//
// What bounds it on this card: device-memory bytes ((K + R) * P at
// 3.35 TB/s, H100 SXM), with the XORs (nnz(W) * P byte-XORs) close behind
// on dense matrices.  The first version (a warp per 16 output rows and a
// 512-byte tile, a bit test and predicated XOR per (row, input) pair, each
// row group re-reading the tile from L1/L2, 4 loads in flight per warp)
// took 0.6905 ms on the dense w=16 shape [64,128] x [128, 2 Mi] (17% of
// its bound) and 0.2041 ms on liber8tion [16,64] x [64, 4 Mi] (49%).
// This design:
//   - a block (8 warps) owns a 512-byte column tile; its K input rows
//     stream through a ring of STAGES slices of SR = 16 rows in shared
//     memory, filled by cp.async (each thread two 16-byte copies per
//     slice) STAGES-1 slices ahead, so HBM is read once and each byte
//     reaches the SM once whatever R is.  Warp w accumulates output rows
//     r0 + w + 8i (i < RPW) in registers, 16 bytes per lane each; past
//     8*RPW = 128 rows the tile streams again per pass of 128 rows;
//   - W's bits are packed once per block into a shared [R, K/16] index of
//     16-bit slice masks (read from W in global memory where the index
//     would not fit, for R*K past 256 Ki);
//   - two forms, chosen per launch:
//     direct: per (row, slice), XOR the staged rows whose bit is set,
//       walking the set bits of the mask (nnz 16-byte loads and XORs per
//       lane-run);
//     tables ("four Russians"): per group of 4 staged rows, two warps
//       build the 16 XOR combinations in Gray-code order (one 16-byte XOR
//       each) into shared memory, and each output row XORs one combination
//       per group, selected by its 4-bit nibble of W (nz_nibbles loads and
//       XORs per lane-run, plus building 16 combinations per group).
//     The rule: tables when nnz(W) > nz_nibbles(W) + 8 * ceil(K/4).  The
//     price of 8 per group was fitted on that card: at liber8tion's
//     W [16, 64] direct wins narrowly at nnz 214 and 240 (0.131 / 0.130 ms
//     against 0.135 / 0.133) and tables win at nnz 552 and 584 (0.134
//     against 0.162 and 0.173); on the dense w=16 matrices tables win by
//     1.5-1.9x.  The kernel counts nnz and nonzero nibbles from W on the
//     card, so the wrapper never waits for the host; rs_kernels.xor_form
//     is the same rule in plain PyTorch.  A caller may name the form
//     (rs_kernels.xor_apply_form), which chip_smoke uses to check both;
//   - a persistent grid (as many blocks as fit on the SMs) walks the
//     (tile, pass) items, and the slice stream runs on across items.
// Measured (ceph_tpu_torch/tools/path_shapes.py):
// dense w=16 0.244 ms, 49% of the bytes bound, where the tables' shared-
// memory traffic (about 11.8k 128-byte wavefronts per tile, counted from
// the code) is what limits it; liber8tion 0.132 ms, 76%.
// Still open: a TMA (cp.async.bulk) ring, and wider tiles per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 8;
constexpr int THREADS = WARP * WARPS;
constexpr int RUN = 16;                // bytes of one row a lane owns
constexpr int TILE = WARP * RUN;       // columns of one block tile
constexpr int SR = 16;                 // input rows per ring slice
constexpr int STAGES = 4;              // ring slices
constexpr int G = 4;                   // input rows per combination group
constexpr int SG = SR / G;             // groups per slice
constexpr int IDX_MAX = 32 * 1024;     // bytes of W index kept in smem
constexpr int BUILD_COST = 8;          // the rule's price of one group

enum { FORM_AUTO = 0, FORM_DIRECT = 1, FORM_TABLES = 2 };

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

__device__ __forceinline__ void xor4(uint4& a, const uint4& b) {
  a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
}

// bit b of the mask = W[row, sl*SR + b] & 1
__device__ __forceinline__ uint32_t mask_from_w(const uint8_t* __restrict__ W,
                                                int K, int row, int sl) {
  const uint8_t* wr = W + (long long)row * K + sl * SR;
  const int n = min(SR, K - sl * SR);
  uint32_t bits = 0;
  for (int b = 0; b < n; ++b) bits |= (uint32_t)(__ldg(wr + b) & 1) << b;
  return bits;
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

// (tile, pass, slice) in the order a block walks them: items blockIdx.x,
// blockIdx.x + gridDim.x, ... of tiles * passes, held as (tile, pass) so
// no step divides
struct Cursor {
  long long tile;
  int pass, sl;
  // dt, dp: gridDim.x as (tiles, passes)
  __device__ void next(int n_sl, long long dt, int dp, int passes) {
    if (++sl < n_sl) return;
    sl = 0;
    tile += dt;
    pass += dp;
    if (pass >= passes) {
      pass -= passes;
      ++tile;
    }
  }
};

template <bool VEC, int RPW>
__global__ void __launch_bounds__(THREADS)
xor_apply_kernel(const uint8_t* __restrict__ W,
                 const uint8_t* __restrict__ packets,
                 uint8_t* __restrict__ out, int R, int K, long long P,
                 int form, int idx_in_smem) {
  extern __shared__ uint4 smem[];
  uint4* ring = smem;                              // [STAGES][SR][WARP]
  uint4* comb = ring + STAGES * SR * WARP;         // [SG][16][WARP]
  uint16_t* idx = reinterpret_cast<uint16_t*>(comb + SG * 16 * WARP);  // [R][n_sl]
  __shared__ unsigned counts[2];                   // nnz, nonzero nibbles

  const int tid = threadIdx.x;
  const int warp = tid / WARP, lane = tid % WARP;
  const int n_sl = (K + SR - 1) / SR;
  const int passes = (R + WARPS * RPW - 1) / (WARPS * RPW);
  const long long tiles = (P + TILE - 1) / TILE;
  const long long items = tiles * passes;
  const long long dt = gridDim.x / passes;
  const int dp = gridDim.x % passes;

  if (K == 0) {                                    // no inputs: zeros
    for (long long it = blockIdx.x; it < items; it += gridDim.x) {
      const long long c0 = (it / passes) * TILE + (long long)lane * RUN;
      const int r0 = (int)(it % passes) * WARPS * RPW;
      if (c0 >= P) continue;
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int row = r0 + warp + WARPS * rr;
        if (row < R)
          store_run<VEC>(out + (long long)row * P, c0, P, make_uint4(0, 0, 0, 0));
      }
    }
    return;
  }

  // the W index and its counts, once per block
  if (tid < 2) counts[tid] = 0;
  __syncthreads();
  if (idx_in_smem) {
    unsigned nnz = 0, nzn = 0;
    for (int e = tid; e < R * n_sl; e += THREADS) {
      const uint32_t bits = mask_from_w(W, K, e / n_sl, e % n_sl);
      idx[e] = (uint16_t)bits;
      nnz += __popc(bits);
#pragma unroll
      for (int g = 0; g < SG; ++g) nzn += ((bits >> (G * g)) & 15) != 0;
    }
    atomicAdd(&counts[0], nnz);
    atomicAdd(&counts[1], nzn);
  }
  __syncthreads();
  const bool tables =
      form == FORM_TABLES ||
      (form == FORM_AUTO && idx_in_smem &&
       counts[0] > counts[1] + (unsigned)BUILD_COST * ((K + G - 1) / G));

  auto slice_mask = [&](int row, int sl) -> uint32_t {
    return idx_in_smem ? (uint32_t)idx[row * n_sl + sl]
                       : mask_from_w(W, K, row, sl);
  };

  // start the loads of one slice into ring slot `slot`: SR rows x 32
  // 16-byte chunks, two per thread
  auto fetch = [&](const Cursor& c, int slot) {
    if (c.tile >= tiles) return;
    const long long col0 = c.tile * TILE;
#pragma unroll
    for (int h = 0; h < SR * WARP / THREADS; ++h) {
      const int q = tid + h * THREADS;
      const int row = q / WARP, lc = q % WARP;
      const int j = c.sl * SR + row;
      if (j >= K) continue;
      const long long c0 = col0 + (long long)lc * RUN;
      const uint8_t* src = packets + (long long)j * P;
      uint4* dst = ring + (slot * SR + row) * WARP + lc;
      if (VEC) {
        if (c0 < P) cp_async16(dst, src + c0);
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int qq = 0; qq < 4; ++qq)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (c0 + qq * 4 + b < P)
              w[qq] |= (uint32_t)__ldg(src + c0 + qq * 4 + b) << (8 * b);
        *dst = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  Cursor f{blockIdx.x / passes, (int)(blockIdx.x % passes), 0};
  Cursor c = f;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    fetch(f, s);
    cp_async_commit();
    f.next(n_sl, dt, dp, passes);
  }
  int slot = 0, fslot = STAGES - 1;
  uint4 acc[RPW];
  while (c.tile < tiles) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();        // slice c is in; every warp is done with c-1
    fetch(f, fslot);        // into the slot slice c-1 used
    cp_async_commit();
    f.next(n_sl, dt, dp, passes);
    fslot = fslot + 1 == STAGES ? 0 : fslot + 1;

    const int r0 = c.pass * WARPS * RPW;
    if (c.sl == 0) {
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) acc[rr] = make_uint4(0, 0, 0, 0);
    }
    const uint4* raw = ring + slot * SR * WARP;
    if (tables) {
      // warp w builds combinations h*8 .. h*8+7 (h = w & 1) of group w >> 1
      const int gi = warp >> 1, h = warp & 1;
      uint4 x[G];
#pragma unroll
      for (int b = 0; b < G; ++b) x[b] = raw[(gi * G + b) * WARP + lane];
      uint4* cg = comb + (gi * 16 + h * 8) * WARP + lane;
      uint4 v = h ? x[3] : make_uint4(0, 0, 0, 0);
      cg[0] = v;
#pragma unroll
      for (int t = 1; t < 8; ++t) {   // Gray code t ^ (t >> 1) flips bit ctz(t)
        xor4(v, x[(t & 1) ? 0 : (t & 2) ? 1 : 2]);
        cg[(t ^ (t >> 1)) * WARP] = v;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int row = r0 + warp + WARPS * rr;
        if (row >= R) break;
        const uint32_t bits = slice_mask(row, c.sl);
#pragma unroll
        for (int g = 0; g < SG; ++g) {
          const uint32_t nib = (bits >> (G * g)) & 15;
          if (nib) xor4(acc[rr], comb[(g * 16 + nib) * WARP + lane]);
        }
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const int row = r0 + warp + WARPS * rr;
        if (row >= R) break;
        uint32_t bits = slice_mask(row, c.sl);
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          xor4(acc[rr], raw[b * WARP + lane]);
        }
      }
    }
    if (c.sl == n_sl - 1) {
      const long long c0 = c.tile * TILE + (long long)lane * RUN;
      if (c0 < P) {
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          const int row = r0 + warp + WARPS * rr;
          if (row >= R) break;
          store_run<VEC>(out + (long long)row * P, c0, P, acc[rr]);
        }
      }
    }
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    c.next(n_sl, dt, dp, passes);
  }
  cp_async_wait<0>();
}

template <bool VEC, int RPW>
cudaError_t launch(const uint8_t* W, const uint8_t* packets, uint8_t* out,
                   int R, int K, long long P, int form, cudaStream_t stream) {
  auto kernel = xor_apply_kernel<VEC, RPW>;
  const long long n_sl = (K + SR - 1) / SR;
  const long long idx_bytes = (long long)R * n_sl * 2;
  const int in_smem = idx_bytes <= IDX_MAX;
  const size_t smem = (size_t)(STAGES * SR + SG * 16) * WARP * sizeof(uint4) +
                      (in_smem ? (size_t)((idx_bytes + 15) / 16 * 16) : 0);
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
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const long long passes = (R + WARPS * RPW - 1) / (WARPS * RPW);
  const long long items = ((P + TILE - 1) / TILE) * passes;
  const long long cap = (long long)sms * fit;
  const int grid = (int)(items < cap ? items : cap);
  kernel<<<grid, THREADS, smem, stream>>>(W, packets, out, R, K, P, form,
                                          in_smem);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t dispatch(const uint8_t* W, const uint8_t* p, uint8_t* o, int R,
                     int K, long long P, int form, cudaStream_t s) {
  // the fewest rows per warp that cover R in one pass (16 past 128 rows)
  if (R <= WARPS * 1) return launch<VEC, 1>(W, p, o, R, K, P, form, s);
  if (R <= WARPS * 2) return launch<VEC, 2>(W, p, o, R, K, P, form, s);
  if (R <= WARPS * 4) return launch<VEC, 4>(W, p, o, R, K, P, form, s);
  if (R <= WARPS * 8) return launch<VEC, 8>(W, p, o, R, K, P, form, s);
  return launch<VEC, 16>(W, p, o, R, K, P, form, s);
}

int run(const void* W, const void* packets, void* out, int R, int K,
        long long P, int form, void* stream) {
  if (R < 1 || K < 0 || P < 1 || form < FORM_AUTO || form > FORM_TABLES)
    return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)packets % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0) && (P % 16 == 0);
  const auto* w = static_cast<const uint8_t*>(W);
  const auto* p = static_cast<const uint8_t*>(packets);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? dispatch<true>(w, p, o, R, K, P, form, s)
                   : dispatch<false>(w, p, o, R, K, P, form, s));
}

}  // namespace

extern "C" {

// out [R, P] = W [R, K] ·GF(2) packets [K, P], all uint8 and contiguous on
// the current device; bit 0 of each W byte is read.  K = 0 writes zeros.
// form: 0 the density rule above, 1 direct, 2 tables.  Launches on
// `stream`, allocates nothing, and returns the cudaError_t of the launch.
int xor_apply_launch(const void* W, const void* packets, void* out, int R,
                     int K, long long P, int form, void* stream) {
  return run(W, packets, out, R, K, P, form, stream);
}

}  // extern "C"
