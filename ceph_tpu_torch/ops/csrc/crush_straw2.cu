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
// What bounds it on this card: integer operations.  Each straw2 draw is a
// 3-word rjenkins hash (183 32-bit operations), a 16-bit ln lookup and an
// exact signed 64-bit quotient, which the card has no instruction for (a
// software routine of several dozen operations); a 2^20-x pool makes tens
// of millions of draws.  The bytes it must move (xs in, out and placed
// out) take a few microseconds at 3.35 TB/s.
//
// This design (the first, simple and exact):
//   - one thread per x, templated on the kind (firstn or indep) and on
//     leaf; every other rule parameter comes at run time, so one build
//     serves every map and rule;
//   - the reference's masked lockstep loops become ordinary loops that
//     leave as soon as the reference's masks would freeze the state: a
//     descent stops where it lands, a firstn rep at its placement, skip
//     or try limit, an indep pass at the positions already filled;
//   - a draw scans the bucket's slots in order with a strict '>' from
//     slot 0 (the first largest draw wins, as jnp.argmax) and skips the
//     hash of a slot whose weight is not positive;
//   - the tables (items, hash ids, weight sets [P, B, S] int64, sizes,
//     types, row_of_id, reweights and the 65,536-entry int64 ln table, 512
//     KiB that stays in L2) are read through __ldg from device memory;
//   - each x's chosen items stay in its row of the output and, for leaf
//     rules, its chosen buckets in the same row of a scratch tensor, so
//     out_size has no cap.
// Later work: a warp per x over the slot scan, the ln table or the
// quotient in shared memory or on tensor cores.
// Limits (the wrapper raises first): n >= 1, B, S, P, n_rows,
// n_reweights >= 1; ln has 65,536 entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NONE = 0x7FFFFFFF;   // CRUSH_ITEM_NONE
constexpr int UNDEF = 0x7FFFFFFE;  // CRUSH_ITEM_UNDEF
constexpr long long LN_BIAS = 0x1000000000000LL;  // 2^48
constexpr long long S64_MIN = -0x7FFFFFFFFFFFFFFFLL - 1;
constexpr uint32_t SEED = 1315423911u;

struct Map {
  const int* items;      // [B, S]
  const int* hash_ids;   // [B, S]
  const long long* ws;   // [P, B, S]
  const int* sizes;      // [B]
  const int* types;      // [B]
  const int* row_of_id;  // [n_rows]
  const long long* reweights;  // [n_reweights]
  const long long* ln;   // [65536]
  int P, B, S, n_rows, n_reweights;
  int root_row, numrep, out_size, target_type, tries, vary_r, stable;
  int max_depth, max_devices;
};

struct Landing {
  int item;
  bool ok;    // landed on the target type
  bool skip;  // a device above the target type or past max_devices
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

// mapper.c bucket_straw2_choose on bucket row `row` with the weight set
// of position min(pos, P - 1); returns the bucket's own item.
__device__ int straw2_choose(const Map& m, int row, uint32_t x, int r,
                             int pos) {
  row = wrap(row, m.B);
  const int p = pos < m.P - 1 ? pos : m.P - 1;
  const long long* w = m.ws + ((long long)p * m.B + row) * m.S;
  const int* hid = m.hash_ids + (long long)row * m.S;
  const int size = __ldg(m.sizes + row);
  const int lim = size < m.S ? size : m.S;
  long long best = S64_MIN;
  int bi = 0;
  for (int i = 0; i < lim; ++i) {
    const long long wi = __ldg(w + i);
    if (wi <= 0) continue;
    const uint32_t u =
        hash3(x, (uint32_t)__ldg(hid + i), (uint32_t)r) & 0xFFFFu;
    const long long draw = -((LN_BIAS - __ldg(m.ln + u)) / wi);
    if (draw > best) {
      best = draw;
      bi = i;
    }
  }
  return __ldg(m.items + (long long)row * m.S + bi);
}

// Walk down from `row` for at most max_depth draws until an item of type
// `ttype` (jax_mapper.py descend).  Running out of depth is neither ok nor
// skip: a retryable reject.
__device__ Landing descend(const Map& m, int row, uint32_t x, int r,
                           int ttype, int pos) {
  int item = 0;
  for (int d = 0; d < m.max_depth; ++d) {
    item = straw2_choose(m, row, x, r, pos);
    const bool is_bucket = item < 0;
    const int nrow =
        is_bucket ? __ldg(m.row_of_id + wrap(-1LL - item, m.n_rows)) : 0;
    const int ntype = is_bucket ? __ldg(m.types + wrap(nrow, m.B)) : 0;
    const bool oob = !is_bucket && item >= m.max_devices;
    const bool hit = ntype == ttype && !oob;
    const bool bad = oob || (!hit && !is_bucket);
    if (hit || bad) return {item, hit, bad};
    row = nrow;
  }
  return {item, false, false};
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

// crush_choose_firstn with no local retries (jax_mapper.py firstn_one).
// res: the x's output row (the leaf devices for a leaf rule), bkt: the
// chosen buckets (the same row as res when not leaf).
template <bool LEAF>
__device__ int firstn(const Map& m, uint32_t x, int* res, int* bkt) {
  int outpos = 0;
  for (int rep = 0; rep < m.numrep && outpos < m.out_size; ++rep) {
    for (int ftotal = 0; ftotal < m.tries; ++ftotal) {
      const int r = rep + ftotal;
      const Landing d = descend(m, m.root_row, x, r, m.target_type, outpos);
      if (d.skip) break;
      if (!d.ok) continue;
      bool collide = false;
      for (int j = 0; j < outpos; ++j) collide |= bkt[j] == d.item;
      if (collide) continue;
      int leaf_item = d.item;
      if constexpr (LEAF) {
        const int sub_r = m.vary_r ? r >> (m.vary_r - 1) : 0;
        const Landing l = descend(m, bucket_row(m, d.item), x,
                                  (m.stable ? 0 : outpos) + sub_r, 0, outpos);
        if (!l.ok) continue;
        bool lcollide = false;
        for (int j = 0; j < outpos; ++j) lcollide |= res[j] == l.item;
        if (lcollide || is_out(m, l.item, x)) continue;
        leaf_item = l.item;
        bkt[outpos] = d.item;
      } else if (m.target_type == 0 && is_out(m, d.item, x)) {
        continue;
      }
      res[outpos] = leaf_item;
      ++outpos;
      break;
    }
  }
  for (int j = outpos; j < m.out_size; ++j) res[j] = NONE;
  return outpos;
}

// crush_choose_indep (jax_mapper.py indep_one): positionally stable.
template <bool LEAF>
__device__ int indep(const Map& m, uint32_t x, int* res, int* bkt) {
  for (int j = 0; j < m.out_size; ++j) {
    res[j] = UNDEF;
    bkt[j] = UNDEF;
  }
  for (int ftotal = 0; ftotal < m.tries; ++ftotal) {
    bool open = false;
    for (int j = 0; j < m.out_size; ++j) open |= bkt[j] == UNDEF;
    if (!open) break;
    for (int rep = 0; rep < m.out_size; ++rep) {
      if (bkt[rep] != UNDEF) continue;
      const int r = rep + m.numrep * ftotal;
      const Landing d = descend(m, m.root_row, x, r, m.target_type, 0);
      if (d.skip) {
        bkt[rep] = NONE;
        res[rep] = NONE;
        continue;
      }
      if (!d.ok) continue;
      bool collide = false;
      for (int j = 0; j < m.out_size; ++j) collide |= bkt[j] == d.item;
      if (collide) continue;
      int leaf_item = d.item;
      if constexpr (LEAF) {
        const Landing l =
            descend(m, bucket_row(m, d.item), x, rep + r, 0, rep);
        if (!l.ok || is_out(m, l.item, x)) continue;
        leaf_item = l.item;
      } else if (m.target_type == 0 && is_out(m, d.item, x)) {
        continue;
      }
      bkt[rep] = d.item;
      res[rep] = leaf_item;
    }
  }
  for (int j = 0; j < m.out_size; ++j)
    if (res[j] == UNDEF) res[j] = NONE;
  return m.out_size;
}

template <bool INDEP, bool LEAF>
__global__ void __launch_bounds__(THREADS)
    crush_straw2_kernel(const uint32_t* __restrict__ xs, long long n, Map m,
                        int* __restrict__ out, int* __restrict__ scratch,
                        int* __restrict__ placed) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t x = __ldg(xs + i);
  int* res = out + i * m.out_size;
  // a leaf rule keeps its buckets apart; otherwise the buckets are the
  // result (firstn: out2 == out, indep: the same row)
  int* bkt = LEAF ? scratch + i * m.out_size : res;
  if constexpr (INDEP)
    placed[i] = indep<LEAF>(m, x, res, bkt);
  else
    placed[i] = firstn<LEAF>(m, x, res, bkt);
}

}  // namespace

extern "C" {

// One launch of the straw2 placement kernel on `stream`.  xs [n] uint32;
// items, hash_ids [B, S] int32; ws [P, B, S] int64; sizes, types [B]
// int32; row_of_id [n_rows] int32; reweights [n_reweights] int64; ln
// [65536] int64; out, scratch [n, out_size] int32 (scratch is used only
// when leaf, and may alias out otherwise); placed [n] int32.  Returns the
// cudaError_t of the launch.
int crush_straw2_launch(const void* xs, long long n, const void* items,
                        const void* hash_ids, const void* ws, int P, int B,
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
  m.ws = static_cast<const long long*>(ws);
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
  const dim3 grid((unsigned)((n + THREADS - 1) / THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
