// GF(2^8) matrix apply on Hopper (sm_90a): out = mat ·GF(2^8) data.
//
// Replaces two TPU kernels of ceph_tpu/ops/pallas_kernels.py with one:
//   gf_apply_pallas / _gf_kernel                     [k, N] -> [r, N]
//     (stripes = 1; rs_kernels.gf_apply)
//   gf_apply_stripes_pallas / _gf_stripes_kernel     vertical layout
//     [S*k, N] -> [S*r, N] (rs_kernels.gf_apply_stripes)
// gf_apply_kernel<VEC> is templated only on whether 16-byte vector loads
// are legal (aligned pointers and N % 16 == 0).
//
// What bounds it on this card: device-memory bytes.  Each column reads k
// data bytes and writes r output bytes, (k + r) * N bytes per call; at
// k=8, r=4 that is 12 bytes per 8 data bytes against 3.35 TB/s (H100 SXM).
// The arithmetic is r*k table lookups per column, far under the card's
// integer rate, so the design keeps every byte moved once:
//   - no bit-plane expansion (the TPU's int8 MXU form inflates data 8x);
//     each (i, j) coefficient becomes a 256-entry product table
//     T[i][j][b] = MUL[mat[i][j]][b], staged into shared memory from the
//     device copy of the 64 KiB MUL table, so a GF multiply is one
//     shared-memory byte lookup;
//   - a thread owns a 16-byte column run: one 16-byte load per data row
//     where the rows are 16-byte aligned (a masked byte path otherwise),
//     XOR-accumulates RB output rows in registers, and stores each output
//     row once;
//   - blocks walk the (stripe, column tile) space with a grid-stride loop,
//     so any stripe count S (1, odd, above 65535) and any N (ragged tails
//     masked) run with one launch, and the tables are staged once per block
//     when they fit.
// Shared memory holds RB rows x KC data rows of tables (RB*KC*256 bytes,
// 8 KiB at k=8).  Wider matrices (the codec admits k + m <= 256) loop over
// row groups of RB and data-row slices of KC, re-staging per tile; above
// 48 KB the launch opts in to the larger dynamic shared memory.
// Not done yet (later work): TMA / cp.async staging, nibble tables or
// byte-permute lookups to cut shared-memory bank conflicts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 4;            // output rows accumulated per pass
constexpr int KC = 128;          // data rows per staged table slice
constexpr int THREADS = 256;
constexpr int RUN = 16;          // bytes of one row a thread owns per tile
constexpr int TILE = THREADS * RUN;

// Stage T[rr][jj][:] = MUL[mat[rg*RB + rr][j0 + jj]][:] for the row group
// and data-row slice; rows past r and columns past k stage zeros.
__device__ void stage_tables(uint32_t* tab, const uint8_t* __restrict__ mat,
                             const uint32_t* __restrict__ mul32, int r, int k,
                             int rg, int j0, int kc) {
  const int words = RB * kc * 64;
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    const int b4 = w & 63;
    const int jj = (w >> 6) % kc;
    const int rr = (w >> 6) / kc;
    const int i = rg * RB + rr;
    const int j = j0 + jj;
    uint32_t v = 0;
    if (i < r && j < k) v = mul32[(int)mat[i * k + j] * 64 + b4];
    tab[w] = v;
  }
}

__device__ __forceinline__ uint32_t lookup4(const uint8_t* t, uint32_t w) {
  return (uint32_t)t[w & 0xff] | ((uint32_t)t[(w >> 8) & 0xff] << 8) |
         ((uint32_t)t[(w >> 16) & 0xff] << 16) | ((uint32_t)t[w >> 24] << 24);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gf_apply_kernel(const uint8_t* __restrict__ mat,
                const uint32_t* __restrict__ mul32,
                const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                int r, int k, long long n, long long stripes, int kc) {
  extern __shared__ uint32_t tab32[];
  const uint8_t* tab = reinterpret_cast<const uint8_t*>(tab32);
  const long long tiles_per_row = (n + TILE - 1) / TILE;
  const long long total = stripes * tiles_per_row;
  const int n_rg = (r + RB - 1) / RB;
  const int n_jc = (k + kc - 1) / kc;
  const bool staged_once = (n_rg == 1 && n_jc == 1);
  if (staged_once) {
    stage_tables(tab32, mat, mul32, r, k, 0, 0, kc);
    __syncthreads();
  }
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    const long long s = t / tiles_per_row;
    const long long c0 = (t % tiles_per_row) * TILE + (long long)threadIdx.x * RUN;
    const bool live = c0 < n;
    const uint8_t* dbase = data + s * (long long)k * n;
    uint8_t* obase = out + s * (long long)r * n;
    for (int rg = 0; rg < n_rg; ++rg) {
      uint32_t acc[RB][4];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rr][q] = 0;
      for (int jc = 0; jc < n_jc; ++jc) {
        const int j0 = jc * kc;
        if (!staged_once) {
          __syncthreads();   // every thread is done with the last slice
          stage_tables(tab32, mat, mul32, r, k, rg, j0, kc);
          __syncthreads();
        }
        if (!live) continue;
        const int j1 = min(k, j0 + kc);
        for (int j = j0; j < j1; ++j) {
          const uint8_t* row = dbase + (long long)j * n + c0;
          uint32_t w[4];
          if (VEC) {
            const uint4 v = *reinterpret_cast<const uint4*>(row);
            w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              uint32_t x = 0;
#pragma unroll
              for (int b = 0; b < 4; ++b) {
                const long long c = c0 + q * 4 + b;
                if (c < n) x |= (uint32_t)row[q * 4 + b] << (8 * b);
              }
              w[q] = x;
            }
          }
          const uint8_t* tj = tab + (j - j0) * 256;
#pragma unroll
          for (int rr = 0; rr < RB; ++rr) {
            const uint8_t* t = tj + rr * kc * 256;
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[rr][q] ^= lookup4(t, w[q]);
          }
        }
      }
      if (!live) continue;
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        const int i = rg * RB + rr;
        if (i >= r) break;
        uint8_t* orow = obase + (long long)i * n + c0;
        if (VEC) {
          *reinterpret_cast<uint4*>(orow) =
              make_uint4(acc[rr][0], acc[rr][1], acc[rr][2], acc[rr][3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (c0 + q * 4 + b < n)
                orow[q * 4 + b] = (uint8_t)(acc[rr][q] >> (8 * b));
        }
      }
    }
  }
}

template <bool VEC>
cudaError_t launch(const uint8_t* mat, const uint32_t* mul32,
                   const uint8_t* data, uint8_t* out, int r, int k,
                   long long n, long long stripes, cudaStream_t stream) {
  const int kc = k < KC ? k : KC;
  const size_t smem = (size_t)RB * kc * 256;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gf_apply_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gf_apply_kernel<VEC>, THREADS, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) per_sm = 1;
  const long long tiles = stripes * ((n + TILE - 1) / TILE);
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(tiles < cap ? tiles : cap);
  gf_apply_kernel<VEC><<<grid, THREADS, smem, stream>>>(
      mat, mul32, data, out, r, k, n, stripes, kc);
  return cudaGetLastError();
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
  if (r < 1 || k < 1 || n < 1 || stripes < 1) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)data % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   (n % 16 == 0);
  const auto* m = static_cast<const uint8_t*>(mat);
  const auto* t = static_cast<const uint32_t*>(mul);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<true>(m, t, d, o, r, k, n, stripes, s)
                   : launch<false>(m, t, d, o, r, k, n, stripes, s));
}

}  // extern "C"
