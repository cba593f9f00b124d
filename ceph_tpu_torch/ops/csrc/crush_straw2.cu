// Bulk straw2 CRUSH placement on Hopper (sm_90a): one take/choose/emit
// rule over xs [n] placement seeds -> out [n, out_size] int32 (NONE holes
// and padding) and placed [n] int32, for a map whose buckets are all
// straw2.
//
// Replaces the jitted XLA function BulkMapper._kernel of
// ceph_tpu/crush/jax_mapper.py (its per-x chooser make_one: straw2_choose,
// is_out, descend, leaf_from, firstn_one, indep_one), called by
// BulkMapper.map_rule.  It runs under osdmap BulkPGMapper.map_pool (every
// PG of a pool), osdmaptool --test-map-pgs, crushtool --test and the
// balancer's calc_weight_set and calc_pg_upmaps, which re-map every PG of
// a pool on each iteration.
//
// What bounds it on this card: integer instruction issue.  Each straw2
// draw is a 3-word rjenkins hash (45 lines of subtract, shift and XOR), a
// 16-bit ln lookup and an exact quotient: the draw loop below is 176-178
// instructions (cuobjdump -sass), of which the XORs, compares and selects
// (61) run only on the ALU pipe's 64 lanes a clock per SM and the rest
// can share the FMA pipe, all within the SM's issue of 128 lanes a clock
// (tools/path_shapes.py: STRAW2_DRAW_WORK, issue_floor, and the recount
// that holds each build to it); a 2^20-x pool makes 10^8 to 4 10^8
// draws.  The bytes it must move (xs in, out and placed out) take
// microseconds.
//
// The design:
//   - one thread per x, which advances its own cursor through the rule's
//     attempts (firstn: the next (rep, try); indep: the next open
//     (pass, position)) and through each attempt's outer and leaf
//     descents.  Every step of the kernel's one loop is the same code for
//     every lane: up to CHUNK slots of the bucket the lane is choosing
//     from.  Lanes on different reps, passes, stages or bucket sizes run
//     it together with their own arguments, so a lane that retries does
//     not hold the warp's other lanes idle beside it (they go on with
//     their own attempts), and a lane on an 8-slot bucket does not wait
//     out a 16-slot scan;
//   - the quotient (2^48 - ln[u]) / w is exact without a division
//     routine: the table build gives each (position, row, slot) of the
//     weight sets a word R = M | l << 56, with w < 2^l and M =
//     ceil(2^(49+l) / w) (so 2^49 <= M <= 2^50), or 0 for a dead slot
//     (weight <= 0 or past the bucket's size), whose hash is skipped.  For
//     every numerator n < 2^49, floor(n / w) = umulhi(n << 15, M) >> l:
//     with e = M w - 2^(49+l) < w, n M / 2^(49+l) = n / w + n e / (w
//     2^(49+l)) and n e < 2^(49+l).  The multiply runs on the FMA pipe,
//     beside the hash's ALU work;
//   - a bucket's choice is the smallest quotient, the first (lowest slot)
//     on a tie (the reference's first largest draw); a bucket with no live
//     slot returns its first item;
//   - each x's placed items and chosen buckets are held in shared memory
//     (up to STATE_CAP positions, position-major so that a warp's lanes
//     hit distinct banks) and its row is written once at the end; a rule
//     with more positions keeps them in its output row and a scratch row
//     instead, so out_size has no cap;
//   - the tables (items, hash ids, reciprocals [P, B, S], sizes, types,
//     row_of_id, reweights and the 65,536-entry int64 ln table, 512 KiB
//     that stays in L2) are read through __ldg.
// Limits (the wrapper raises first): n >= 1, B, S, P, n_rows,
// n_reweights >= 1; ln has 65,536 entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 8;           // slots of a bucket a step
constexpr int STATE_CAP = 16;      // positions of per-x state in shared memory
constexpr int NONE = 0x7FFFFFFF;   // CRUSH_ITEM_NONE
constexpr int UNDEF = 0x7FFFFFFE;  // CRUSH_ITEM_UNDEF
constexpr long long LN_BIAS = 0x1000000000000LL;  // 2^48
constexpr int RECIP_SHIFT = 56;  // a reciprocal word is M | l << 56
constexpr unsigned long long RECIP_M = (1ULL << RECIP_SHIFT) - 1;
constexpr unsigned long long NO_DRAW = ~0ULL;
constexpr uint32_t SEED = 1315423911u;

struct Map {
  const int* items;                 // [B, S]
  const int* hash_ids;              // [B, S]
  const unsigned long long* recip;  // [P, B, S]
  const int* sizes;                 // [B]
  const int* types;                 // [B]
  const int* row_of_id;             // [n_rows]
  const long long* reweights;       // [n_reweights]
  const long long* ln;              // [65536]
  int P, B, S, n_rows, n_reweights;
  int root_row, numrep, out_size, target_type, tries, vary_r, stable;
  int max_depth, max_devices;
};

struct Landing {
  int item;
  bool ok;    // landed on the target type
  bool skip;  // a device above the target type or past max_devices
};

// Per-x state: positions j of a shared-memory or global row at a stride.
struct Row {
  int* p;
  int stride;
  __device__ __forceinline__ int& operator[](int j) const {
    return p[j * stride];
  }
  // Whether positions [0, n) hold v.  EVERY reads them all (a trip count
  // the same for every lane) rather than leaving at the first hit: on
  // sm_90a that measured faster for indep and slower for firstn.
  template <bool EVERY>
  __device__ __forceinline__ bool holds(int n, int v) const {
    if constexpr (EVERY) {
      bool hit = false;
      for (int j = 0; j < n; ++j) hit |= p[j * stride] == v;
      return hit;
    } else {
      for (int j = 0; j < n; ++j)
        if (p[j * stride] == v) return true;
      return false;
    }
  }
};

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b,
                                          uint32_t c) {
  uint32_t h = SEED ^ a ^ b ^ c, x = 231232, y = 1232;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  uint32_t h = SEED ^ a ^ b, x = 231232, y = 1232;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

// An index into n rows as the reference gathers: a negative index counts
// from the end, one past either end is clamped.
__device__ __forceinline__ int wrap(long long i, int n) {
  if (i < 0) i += n;
  return (int)(i < 0 ? 0 : (i >= n ? n - 1 : i));
}

// floor((2^48 - ln[u]) / w) from w's reciprocal word rc (see the header).
__device__ __forceinline__ unsigned long long quotient(
    const Map& m, uint32_t u, unsigned long long rc) {
  const unsigned long long n =
      (unsigned long long)(LN_BIAS - __ldg(m.ln + u));
  return __umul64hi(n << 15, rc & RECIP_M) >> (unsigned)(rc >> RECIP_SHIFT);
}

// What a landing on `item` means for a descent to type `ttype`
// (jax_mapper.py descend): ok, skip, or walk on to row *nrow.
__device__ __forceinline__ Landing classify(const Map& m, int item,
                                            int ttype, int* nrow) {
  const bool is_bucket = item < 0;
  *nrow = is_bucket ? __ldg(m.row_of_id + wrap(-1LL - item, m.n_rows)) : 0;
  const int ntype = is_bucket ? __ldg(m.types + wrap(*nrow, m.B)) : 0;
  const bool oob = !is_bucket && item >= m.max_devices;
  const bool hit = ntype == ttype && !oob;
  const bool bad = oob || (!hit && !is_bucket);
  return {item, hit, bad};
}

// mapper.c is_out: the device is rejected under its reweight.
__device__ bool is_out(const Map& m, int item, uint32_t x) {
  if (item >= m.n_reweights) return true;
  const long long w = __ldg(m.reweights + (item < 0 ? 0 : item));
  if (w == 0) return true;
  if (w >= 0x10000) return false;
  return (long long)(hash2(x, (uint32_t)item) & 0xFFFFu) >= w;
}

__device__ __forceinline__ int bucket_row(const Map& m, int item) {
  return item < 0 ? __ldg(m.row_of_id + wrap(-1LL - item, m.n_rows)) : 0;
}


template <bool INDEP, bool LEAF>
__global__ void __launch_bounds__(THREADS)
    crush_straw2_kernel(const uint32_t* __restrict__ xs, long long n, Map m,
                        int* __restrict__ out, int* __restrict__ scratch,
                        int* __restrict__ placed) {
  __shared__ int state[2][STATE_CAP][THREADS];
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = __ldg(xs + i);
  int* row_out = out + i * m.out_size;
  const bool in_smem = m.out_size <= STATE_CAP;
  const Row res = in_smem ? Row{&state[0][0][threadIdx.x], THREADS}
                          : Row{row_out, 1};
  // a leaf rule keeps its buckets apart; otherwise the buckets are the
  // result (firstn: out2 == out, indep: the same row)
  const Row bkt = !LEAF ? res
                  : in_smem ? Row{&state[1][0][threadIdx.x], THREADS}
                            : Row{scratch + i * m.out_size, 1};
  if constexpr (INDEP) {
    for (int j = 0; j < m.out_size; ++j) {
      res[j] = UNDEF;
      bkt[j] = UNDEF;
    }
  }
  // the attempt cursor: firstn (rep, ftotal, outpos); indep (ftotal, rep)
  int rep = 0, ftotal = 0, outpos = 0;
  // the descent in flight: outer or leaf stage, its row, r, weight-set
  // position, target type and depth; the outer attempt's r and, in the
  // leaf stage, its landing
  bool leaf_stage = false;
  int row = 0, r = 0, wpos = 0, ttype = 0, depth = 0, r_outer = 0;
  int d_item = 0;
  // the bucket choice in flight: slots [slot, lim) of row crow are left
  const unsigned long long* rc = nullptr;
  const int* hid = nullptr;
  int crow = 0, lim = 0, slot = 0, bi = 0;
  unsigned long long best = NO_DRAW;

  // mapper.c bucket_straw2_choose starts on `row` with the weight set of
  // position min(wpos, P - 1)
  auto start_choice = [&]() {
    crow = wrap(row, m.B);
    const int p = wpos < m.P - 1 ? wpos : m.P - 1;
    rc = m.recip + ((long long)p * m.B + crow) * m.S;
    hid = m.hash_ids + (long long)crow * m.S;
    const int size = __ldg(m.sizes + crow);
    lim = size < m.S ? size : m.S;
    slot = 0;
    bi = 0;
    best = NO_DRAW;
  };
  // sets up the next attempt's outer descent; false when the x is done
  auto begin = [&]() -> bool {
    if constexpr (INDEP) {
      for (;;) {
        while (rep < m.out_size && bkt[rep] != UNDEF) ++rep;
        if (rep < m.out_size) break;
        if (++ftotal >= m.tries || !bkt.holds<INDEP>(m.out_size, UNDEF))
          return false;
        rep = 0;
      }
      r = rep + m.numrep * ftotal;
      wpos = 0;
    } else {
      if (rep >= m.numrep || outpos >= m.out_size) return false;
      r = rep + ftotal;
      wpos = outpos;
    }
    r_outer = r;
    row = m.root_row;
    ttype = m.target_type;
    depth = 0;
    leaf_stage = false;
    start_choice();
    return true;
  };
  // a rejected attempt: the next try (firstn) or position (indep)
  auto reject = [&]() {
    if constexpr (INDEP) {
      ++rep;
    } else if (++ftotal >= m.tries) {
      ++rep;
      ftotal = 0;
    }
  };
  auto place = [&](int bucket, int item) {
    if constexpr (INDEP) {
      bkt[rep] = bucket;
      res[rep] = item;
      ++rep;
    } else {
      if (LEAF) bkt[outpos] = bucket;
      res[outpos] = item;
      ++outpos;
      ++rep;
      ftotal = 0;
    }
  };

  bool active = m.tries > 0 && begin();
  while (active) {
    Landing l{0, false, false};
    if (depth < m.max_depth) {
      // the step: up to CHUNK slots, the hash skipped for a dead one; a
      // strict '<' keeps the first smallest quotient
      for (int k = 0; k < CHUNK && slot < lim; ++k, ++slot) {
        const unsigned long long c = __ldg(rc + slot);
        if (c == 0) continue;
        const uint32_t u =
            hash3(x, (uint32_t)__ldg(hid + slot), (uint32_t)r) & 0xFFFFu;
        const unsigned long long q = quotient(m, u, c);
        if (q < best) {
          best = q;
          bi = slot;
        }
      }
      if (slot < lim) continue;
      const int item = __ldg(m.items + (long long)crow * m.S + bi);
      int nrow;
      l = classify(m, item, ttype, &nrow);
      // walk on down (jax_mapper.py descend: at most max_depth draws;
      // running out of depth is neither ok nor skip, a retryable reject)
      if (!l.ok && !l.skip && ++depth < m.max_depth) {
        row = nrow;
        start_choice();
        continue;
      }
    }
    if (!leaf_stage) {
      if (l.skip) {
        // indep pins the position to NONE; firstn gives up the rep
        if constexpr (INDEP) {
          bkt[rep] = NONE;
          res[rep] = NONE;
          ++rep;
        } else {
          ++rep;
          ftotal = 0;
        }
      } else if (!l.ok ||
                 bkt.holds<INDEP>(INDEP ? m.out_size : outpos, l.item)) {
        reject();
      } else if (LEAF) {
        // descend the chosen bucket once more to a device (firstn: r =
        // (stable ? 0 : outpos) + r >> (vary_r - 1) at position outpos;
        // indep: r = rep + r at position rep)
        leaf_stage = true;
        d_item = l.item;
        row = bucket_row(m, l.item);
        if constexpr (INDEP) {
          r = rep + r_outer;
          wpos = rep;
        } else {
          const int sub_r = m.vary_r ? r_outer >> (m.vary_r - 1) : 0;
          r = (m.stable ? 0 : outpos) + sub_r;
          wpos = outpos;
        }
        ttype = 0;
        depth = 0;
        start_choice();
        continue;
      } else if (m.target_type == 0 && is_out(m, l.item, x)) {
        reject();
      } else {
        place(l.item, l.item);
      }
    } else if (!l.ok || (!INDEP && res.holds<INDEP>(outpos, l.item)) ||
               is_out(m, l.item, x)) {
      reject();
    } else {
      place(d_item, l.item);
    }
    active = begin();
  }
  const int np = INDEP ? m.out_size : outpos;
  for (int j = 0; j < m.out_size; ++j) {
    const int v = res[j];
    row_out[j] = INDEP ? (v == UNDEF ? NONE : v) : (j < np ? v : NONE);
  }
  placed[i] = np;
}

}  // namespace

extern "C" {

// One launch of the straw2 placement kernel on `stream`.  xs [n] uint32;
// items, hash_ids [B, S] int32; recip [P, B, S] uint64 (the reciprocal
// words of the weight sets, see the header); sizes, types [B] int32;
// row_of_id [n_rows] int32; reweights [n_reweights] int64; ln [65536]
// int64; out, scratch [n, out_size] int32 (scratch is used only when leaf
// and out_size > STATE_CAP, and may alias out otherwise); placed [n] int32.
// Returns the cudaError_t of the launch.
int crush_straw2_launch(const void* xs, long long n, const void* items,
                        const void* hash_ids, const void* recip, int P, int B,
                        int S, const void* sizes, const void* types,
                        const void* row_of_id, int n_rows,
                        const void* reweights, int n_reweights,
                        const void* ln, void* out, void* scratch,
                        void* placed, int indep, int leaf, int root_row,
                        int numrep, int out_size, int target_type, int tries,
                        int vary_r, int stable, int max_depth,
                        int max_devices, void* stream) {
  if (n < 1 || P < 1 || B < 1 || S < 1 || n_rows < 1 || n_reweights < 1 ||
      out_size < 0 || vary_r < 0)
    return (int)cudaErrorInvalidValue;
  Map m;
  m.items = static_cast<const int*>(items);
  m.hash_ids = static_cast<const int*>(hash_ids);
  m.recip = static_cast<const unsigned long long*>(recip);
  m.sizes = static_cast<const int*>(sizes);
  m.types = static_cast<const int*>(types);
  m.row_of_id = static_cast<const int*>(row_of_id);
  m.reweights = static_cast<const long long*>(reweights);
  m.ln = static_cast<const long long*>(ln);
  m.P = P;
  m.B = B;
  m.S = S;
  m.n_rows = n_rows;
  m.n_reweights = n_reweights;
  m.root_row = root_row;
  m.numrep = numrep;
  m.out_size = out_size;
  m.target_type = target_type;
  m.tries = tries;
  m.vary_r = vary_r;
  m.stable = stable;
  m.max_depth = max_depth;
  m.max_devices = max_devices;
  const uint32_t* xs_p = static_cast<const uint32_t*>(xs);
  int* out_p = static_cast<int*>(out);
  int* scratch_p = static_cast<int*>(scratch);
  int* placed_p = static_cast<int*>(placed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS));
  if (indep) {
    if (leaf)
      crush_straw2_kernel<true, true>
          <<<grid, THREADS, 0, s>>>(xs_p, n, m, out_p, scratch_p, placed_p);
    else
      crush_straw2_kernel<true, false>
          <<<grid, THREADS, 0, s>>>(xs_p, n, m, out_p, scratch_p, placed_p);
  } else {
    if (leaf)
      crush_straw2_kernel<false, true>
          <<<grid, THREADS, 0, s>>>(xs_p, n, m, out_p, scratch_p, placed_p);
    else
      crush_straw2_kernel<false, false>
          <<<grid, THREADS, 0, s>>>(xs_p, n, m, out_p, scratch_p, placed_p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
