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
// i from product row b*r + i.  With G groups a block owns G column tiles
// of tile_n columns and multiplies their G*8k stacked bits by the whole
// block-diagonal operand, as _kernel_bd does; unlike it, every column of
// the one output [r, N] is written, and a ragged N is masked.
//
// What bounds it on this card: device-memory bytes ((k + r) * N at
// 3.35 TB/s) for the int8 product at G = 1; the tensor-core operations
// (2 * G*8r * G*8k * N/G) for bf16 and for the block-diagonal stacks.
// mma.sync does not reach the wgmma peak those bounds assume.  The design:
//   - the product runs on the tensor cores through warp-level mma.sync:
//     m16n8k32 s8*s8->s32 (acc = int8) or m16n8k16 bf16*bf16->f32
//     (acc = bf16); both are exact, the terms are 0/1 and at most 8*G*k;
//   - the bit-plane operand is never written to device memory: a block
//     stages raw data bytes of a 256-column sub-tile in shared memory,
//     transposed to column-major (4x4 byte transposes with prmt), and each
//     lane builds its B fragment in registers with one shift and mask:
//     (4 data bytes of rows j..j+3 >> b) & 0x01010101 is four s8 bits of
//     plane b.  k is padded to kp = round_up(k, 4) inside the kernel so a
//     fragment's 4 (int8) or 2 (bf16) K values share one plane;
//   - the operand A sits in shared memory as 0/1 bytes in an internal row
//     order chosen for the repack: the 8 bits of one output byte land in
//     rows {gid, gid+8} of two M tiles in lanes gid and gid+4, so a lane
//     ORs 4 bits from its C fragments and one __shfl_xor_sync(16) joins the
//     two nibbles.  M pads to 32 rows per 4 output rows (zero rows);
//   - shared memory, not the tensor cores, is what the loop waits on: A
//     rows are padded so a fragment load hits 32 banks (unpadded, a 64-byte
//     row stride made them 4-way conflicts), and a warp multiplies each A
//     fragment into up to 4 n-tiles of 8 columns before loading the next;
//     together these doubled the speed at G = 1 and gave 6x at G = 4;
//   - what remains is instructions, not tensor-core time: building B
//     fragments, the repack and the byte transposes cost about a dozen
//     warp instructions per column, and a block waits on its staging
//     loads between sub-tiles (no prefetch);
//   - output bytes are staged in shared memory and stored as words.
// Limits (the wrapper raises first): G*r <= 32, G*kp <= 64, tile_n a
// multiple of 256.  Not done yet: wgmma, TMA or cp.async staging with a
// prefetch of the next sub-tile, ldmatrix.
//
// copy_rows_launch: out[r, N] = data[:r].  It reads every byte of all k
// rows, as the TPU kernel's BlockSpec((k, tile_n)) does, and writes r rows:
// the ceiling for the (k + r) * N traffic of a GF apply.  Bound by bytes.
// The loads of rows r..k-1 are XOR-folded into a value that is stored only
// through a pointer the host passes as null, so nvcc cannot drop them.
// 16-byte loads and stores where aligned, a masked byte path otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TC = 256;             // columns of one group per sub-tile

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two 0/1 bytes (low: the smaller K index) -> a pair of bf16 0.0/1.0
__device__ __forceinline__ uint32_t bf16_pair(uint32_t two_bits) {
  return __byte_perm(two_bits, 0, 0x4140) * 0x3F80u;
}

__device__ __forceinline__ int low_bit(int x) { return x & 1; }
__device__ __forceinline__ int low_bit(float x) {
  return __float2int_rn(x) & 1;
}

template <bool BF16> struct AccType { using T = int; };
template <> struct AccType<true> { using T = float; };

// Shared-memory strides in bytes.  A row: kpad bytes padded to 4 banks
// past a multiple of 32 words, so the 8 rows x 4 lanes of a fragment load
// hit 32 banks.  D column: gkp bytes padded to an odd number of words.
__host__ __device__ constexpr int a_stride(int kpad) {
  return 4 * (kpad / 4 + (36 - (kpad / 4) % 32) % 32);
}
__host__ __device__ constexpr int d_stride(int gkp) {
  return 4 * ((gkp / 4) | 1);
}

// NB: blocks of 32 internal rows (4 output rows each); MT = 2*NB M tiles;
// a warp takes NT n-tiles of 8 columns at once and reuses each A fragment
// across them
template <int NB, bool BF16>
__global__ void __launch_bounds__(THREADS)
bitplane_kernel(const uint8_t* __restrict__ bmat,
                const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                int r, int k, long long n, int G, long long tile_n, int kp,
                bool vec) {
  using Acc = typename AccType<BF16>::T;
  constexpr int MPAD = NB * 32;
  constexpr int MT = NB * 2;
  constexpr int NT = NB <= 2 ? 4 : 8 / NB;
  extern __shared__ __align__(16) uint8_t smem[];
  const int kpad = 8 * G * kp;              // internal K: G groups x 8 planes x kp
  const int gkp = G * kp;                   // data bytes of one staged column
  const int units = G * r;                  // output rows of the stack
  const int as = a_stride(kpad), ds = d_stride(gkp);
  uint8_t* A_s = smem;                                   // [MPAD, as]
  uint32_t* kinfo = reinterpret_cast<uint32_t*>(smem + MPAD * as);
  uint8_t* D_s = smem + MPAD * as + kpad * 2;            // [TC, ds]
  uint8_t* O_s = D_s + TC * ds;                          // [units, TC]

  // A in the internal order: row (blk, t, h, gid) holds bit
  // b = 4*(gid/4) + 2t + h of unit u = 4*blk + gid%4 (group u/r, row u%r);
  // column kk = (g, plane, j) with j < kp.  Padding rows and columns are 0.
  const int bcols = G * 8 * k;
#pragma unroll 4
  for (int e = threadIdx.x; e < MPAD * kpad; e += THREADS) {
    const int row = e / kpad, kk = e % kpad;
    const int gid = row & 7, h = (row >> 3) & 1, t = (row >> 4) & 1;
    const int u = (row >> 5) * 4 + (gid & 3);
    const int b = (gid >> 2) * 4 + t * 2 + h;
    const int g2 = kk / (8 * kp), rem = kk % (8 * kp);
    const int b2 = rem / kp, j = rem % kp;
    uint8_t v = 0;
    if (u < units && j < k) {
      const int g = u / r, i = u % r;
      v = bmat[(long long)(g * 8 * r + b * r + i) * bcols + g2 * 8 * k +
               b2 * k + j] & 1;
    }
    A_s[row * as + kk] = v;
  }
  // per K pair: (plane << 16) | byte offset of row j within a staged column
  for (int p = threadIdx.x; p < kpad / 2; p += THREADS) {
    const int kk = 2 * p;
    const int g2 = kk / (8 * kp), rem = kk % (8 * kp);
    kinfo[p] = ((uint32_t)(rem / kp) << 16) | (uint32_t)(g2 * kp + rem % kp);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const long long base = (long long)blockIdx.x * G * tile_n;
  const int kq = kp / 4;
  const int ksteps = BF16 ? kpad / 16 : kpad / 32;

  for (long long c0 = 0; c0 < tile_n; c0 += TC) {
    if (base + c0 >= n) break;              // the same for every thread
    // stage D_s[c*ds + g*kp + j] = data[j, base + g*tile_n + c0 + c]
    const int quads = G * kq * (TC / 4);
    for (int q = threadIdx.x; q < quads; q += THREADS) {
      const int cq = q % (TC / 4);
      const int jq = (q / (TC / 4)) % kq;
      const int g = q / (TC / 4) / kq;
      const long long col = base + g * tile_n + c0 + cq * 4;
      uint32_t rw[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int j = jq * 4 + y;
        uint32_t w = 0;
        if (j < k && col < n) {
          const uint8_t* src = data + (long long)j * n + col;
          if (vec) {
            w = __ldg(reinterpret_cast<const uint32_t*>(src));
          } else {
#pragma unroll
            for (int x = 0; x < 4; ++x)
              if (col + x < n) w |= (uint32_t)__ldg(src + x) << (8 * x);
          }
        }
        rw[y] = w;
      }
      const uint32_t t0 = __byte_perm(rw[0], rw[1], 0x5140);
      const uint32_t t1 = __byte_perm(rw[0], rw[1], 0x7362);
      const uint32_t t2 = __byte_perm(rw[2], rw[3], 0x5140);
      const uint32_t t3 = __byte_perm(rw[2], rw[3], 0x7362);
      uint8_t* dst = D_s + (cq * 4) * ds + g * kp + jq * 4;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + ds) = __byte_perm(t0, t2, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * ds) = __byte_perm(t1, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * ds) = __byte_perm(t1, t3, 0x7632);
    }
    __syncthreads();

    for (int nt0 = warp * NT; nt0 < TC / 8; nt0 += WARPS * NT) {
      Acc acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nn = 0; nn < NT; ++nn)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nn][q] = 0;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t b0[NT], b1[NT];
        if constexpr (BF16) {
          // B rows tig*2+{0,1} (b0) and 8+tig*2+{0,1} (b1) of this K step
          const uint32_t i0 = kinfo[ks * 8 + tig];
          const uint32_t i1 = kinfo[ks * 8 + 4 + tig];
#pragma unroll
          for (int nn = 0; nn < NT; ++nn) {
            const uint8_t* dcol = D_s + ((nt0 + nn) * 8 + gid) * ds;
            const uint32_t h0 = *reinterpret_cast<const uint16_t*>(dcol + (i0 & 0xFFFF));
            const uint32_t h1 = *reinterpret_cast<const uint16_t*>(dcol + (i1 & 0xFFFF));
            b0[nn] = bf16_pair((h0 >> (i0 >> 16)) & 0x0101u);
            b1[nn] = bf16_pair((h1 >> (i1 >> 16)) & 0x0101u);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint8_t* arow = A_s + (mt * 16 + gid) * as + ks * 16 + tig * 2;
            const uint8_t* arow8 = arow + 8 * as;
            const uint32_t a0 = bf16_pair(*reinterpret_cast<const uint16_t*>(arow));
            const uint32_t a1 = bf16_pair(*reinterpret_cast<const uint16_t*>(arow8));
            const uint32_t a2 = bf16_pair(*reinterpret_cast<const uint16_t*>(arow + 8));
            const uint32_t a3 = bf16_pair(*reinterpret_cast<const uint16_t*>(arow8 + 8));
#pragma unroll
            for (int nn = 0; nn < NT; ++nn)
              mma_bf16(acc[mt][nn], a0, a1, a2, a3, b0[nn], b1[nn]);
          }
        } else {
          // B rows tig*4+{0..3} (b0) and 16+tig*4+{0..3} (b1)
          const uint32_t i0 = kinfo[ks * 16 + tig * 2];
          const uint32_t i1 = kinfo[ks * 16 + 8 + tig * 2];
#pragma unroll
          for (int nn = 0; nn < NT; ++nn) {
            const uint8_t* dcol = D_s + ((nt0 + nn) * 8 + gid) * ds;
            b0[nn] = (*reinterpret_cast<const uint32_t*>(dcol + (i0 & 0xFFFF)) >>
                      (i0 >> 16)) & 0x01010101u;
            b1[nn] = (*reinterpret_cast<const uint32_t*>(dcol + (i1 & 0xFFFF)) >>
                      (i1 >> 16)) & 0x01010101u;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint8_t* arow = A_s + (mt * 16 + gid) * as + ks * 32 + tig * 4;
            const uint8_t* arow8 = arow + 8 * as;
            const uint32_t a0 = *reinterpret_cast<const uint32_t*>(arow);
            const uint32_t a1 = *reinterpret_cast<const uint32_t*>(arow8);
            const uint32_t a2 = *reinterpret_cast<const uint32_t*>(arow + 16);
            const uint32_t a3 = *reinterpret_cast<const uint32_t*>(arow8 + 16);
#pragma unroll
            for (int nn = 0; nn < NT; ++nn)
              mma_s8(acc[mt][nn], a0, a1, a2, a3, b0[nn], b1[nn]);
          }
        }
      }
      // C: acc[mt][nn][0..1] rows gid, [2..3] rows gid+8, columns
      // tig*2 + {0, 1}; a 32-row block gives lane gid bits 2t+h of its
      // nibble (low nibble for gid < 4, high nibble in lane + 16)
#pragma unroll
      for (int nn = 0; nn < NT; ++nn) {
#pragma unroll
        for (int blk = 0; blk < NB; ++blk) {
          const Acc* lo = acc[2 * blk][nn];
          const Acc* up = acc[2 * blk + 1][nn];
          uint32_t v = 0;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t nib = low_bit(lo[e]) | (low_bit(lo[2 + e]) << 1) |
                                 (low_bit(up[e]) << 2) |
                                 (low_bit(up[2 + e]) << 3);
            v |= nib << (8 * e);
          }
          const uint32_t hi = __shfl_xor_sync(0xffffffffu, v, 16);
          const int u = blk * 4 + gid;
          if (gid < 4 && u < units) {
            uint8_t* o = O_s + u * TC + (nt0 + nn) * 8 + tig * 2;
            o[0] = (uint8_t)((v & 0xF) | ((hi & 0xF) << 4));
            o[1] = (uint8_t)(((v >> 8) & 0xF) | (((hi >> 8) & 0xF) << 4));
          }
        }
      }
    }
    __syncthreads();

    // out[i, base + g*tile_n + c0 + c] = O_s[(g*r + i)*TC + c]
    for (int q = threadIdx.x; q < units * (TC / 4); q += THREADS) {
      const int cq = q % (TC / 4), u = q / (TC / 4);
      const int g = u / r, i = u % r;
      const long long col = base + g * tile_n + c0 + cq * 4;
      if (col >= n) continue;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(O_s + u * TC + cq * 4);
      uint8_t* dst = out + (long long)i * n + col;
      if (vec) {
        *reinterpret_cast<uint32_t*>(dst) = w;
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (col + x < n) dst[x] = (uint8_t)(w >> (8 * x));
      }
    }
    // the next sub-tile's first __syncthreads orders these reads of O_s
    // before its writes
  }
}

template <int NB, bool BF16>
cudaError_t launch_bitplane(const uint8_t* bmat, const uint8_t* data,
                            uint8_t* out, int r, int k, long long n, int G,
                            long long tile_n, int kp, bool vec,
                            cudaStream_t stream) {
  const int kpad = 8 * G * kp;
  const size_t smem = (size_t)NB * 32 * a_stride(kpad) + (size_t)kpad * 2 +
                      (size_t)TC * d_stride(G * kp) + (size_t)G * r * TC;
  cudaError_t err;
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin,
                                    cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess)
    return err;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bitplane_kernel<NB, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long span = (long long)G * tile_n;
  const long long blocks = (n + span - 1) / span;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bitplane_kernel<NB, BF16><<<(unsigned)blocks, THREADS, smem, stream>>>(
      bmat, data, out, r, k, n, G, tile_n, kp, vec);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch_nb(int nb, const uint8_t* bmat, const uint8_t* data,
                        uint8_t* out, int r, int k, long long n, int G,
                        long long tile_n, int kp, bool vec,
                        cudaStream_t s) {
  switch (nb) {
    case 1: return launch_bitplane<1, BF16>(bmat, data, out, r, k, n, G, tile_n, kp, vec, s);
    case 2: return launch_bitplane<2, BF16>(bmat, data, out, r, k, n, G, tile_n, kp, vec, s);
    case 4: return launch_bitplane<4, BF16>(bmat, data, out, r, k, n, G, tile_n, kp, vec, s);
    case 8: return launch_bitplane<8, BF16>(bmat, data, out, r, k, n, G, tile_n, kp, vec, s);
  }
  return cudaErrorInvalidValue;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
copy_rows_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 int r, int k, long long n, long long tile_n,
                 uint32_t* sink_out) {
  const long long base = (long long)blockIdx.x * tile_n;
  uint32_t sink = 0;
  for (long long c = (long long)threadIdx.x * 16; c < tile_n; c += THREADS * 16) {
    const long long col = base + c;
    if (col >= n) break;
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const uint8_t* src = data + (long long)j * n + col;
      uint4 v;
      if (VEC) {
        v = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int x = 0; x < 16; ++x)
          if (col + x < n) w[x / 4] |= (uint32_t)__ldg(src + x) << (8 * (x % 4));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      if (j < r) {
        uint8_t* dst = out + (long long)j * n + col;
        if (VEC) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int x = 0; x < 16; ++x)
            if (col + x < n) dst[x] = (uint8_t)(w[x / 4] >> (8 * (x % 4)));
        }
      } else {
        sink ^= v.x ^ v.y ^ v.z ^ v.w;
      }
    }
  }
  if (sink_out != nullptr) atomicXor(sink_out, sink);
}

template <bool VEC>
cudaError_t launch_copy(const uint8_t* data, uint8_t* out, int r, int k,
                        long long n, long long tile_n, cudaStream_t stream) {
  const long long blocks = (n + tile_n - 1) / tile_n;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  copy_rows_kernel<VEC><<<(unsigned)blocks, THREADS, 0, stream>>>(
      data, out, r, k, n, tile_n, nullptr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [r, n] = mat ·GF(2^8) data [k, n] through the plane-major bit-matrix
// bmat [groups*8r, groups*8k] (0/1 bytes; bit 0 is read), block-diagonal
// for groups > 1.  acc: 0 = int8 (m16n8k32), 1 = bf16 (m16n8k16).  A block
// owns groups column tiles of tile_n columns.  Requires groups*r <= 32,
// groups*round_up(k, 4) <= 64 and tile_n a positive multiple of 256.
// Launches on `stream`, allocates nothing, returns the cudaError_t.
int bitplane_apply_launch(const void* bmat, const void* data, void* out,
                          int r, int k, long long n, int groups,
                          long long tile_n, int acc, void* stream) {
  const int kp = (k + 3) / 4 * 4;
  if (r < 1 || k < 1 || n < 1 || groups < 1 || groups * r > 32 ||
      groups * kp > 64 || tile_n < TC || tile_n % TC != 0 ||
      (acc != 0 && acc != 1))
    return (int)cudaErrorInvalidValue;
  const int blocks32 = (groups * r + 3) / 4;
  int nb = 1;
  while (nb < blocks32) nb *= 2;
  const bool vec = ((uintptr_t)data % 4 == 0) && ((uintptr_t)out % 4 == 0) &&
                   (n % 4 == 0);
  const auto* b = static_cast<const uint8_t*>(bmat);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(acc == 1
                   ? dispatch_nb<true>(nb, b, d, o, r, k, n, groups, tile_n, kp, vec, s)
                   : dispatch_nb<false>(nb, b, d, o, r, k, n, groups, tile_n, kp, vec, s));
}

// out [r, n] = data [:r] of data [k, n], reading all k rows; a block owns
// tile_n columns (a positive multiple of 256).  Returns the cudaError_t.
int copy_rows_launch(const void* data, void* out, int r, int k, long long n,
                     long long tile_n, void* stream) {
  if (r < 1 || k < r || n < 1 || tile_n < TC || tile_n % TC != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)data % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                   (n % 16 == 0);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_copy<true>(d, o, r, k, n, tile_n, s)
                   : launch_copy<false>(d, o, r, k, n, tile_n, s));
}

}  // extern "C"
