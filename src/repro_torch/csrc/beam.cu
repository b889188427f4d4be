// beam: the range-filtered beam search of a whole batch in one kernel,
// one thread block per query running that query's hop loop to its end.
//
// Replaces, on the search path, the per-hop launches of gather_dist.cu's
// kernels (the port of src/repro/kernels/gather_dist.py::gather_dist_pallas,
// bw 1, and ::gather_topk_pallas, bw > 1) together with the lockstep torch
// loop around them (src/repro_torch/kernels/ref.py::beam_single_ref,
// ::beam_batched_ref): the reference's per-query lax.while_loop under vmap
// (src/repro/core/beam.py) becomes a loop inside a block, and a finished
// query's block simply leaves its loop while the others run on.
//
// Per hop, as the reference and the plain loop define it:
//   beam_single (bw 1): expand the first minimum of the unexpanded pool
//     (position 0 when every unexpanded distance is +inf), read the exact
//     visited set for the node's whole neighbour row before writing it (a
//     duplicate id in one row is scored twice), score the fresh neighbours
//     and fold them into the pool.
//   beam_batched (bw > 1): expand the first B selectable (unexpanded,
//     finite) positions of the sorted pool; drop a neighbour that an
//     earlier position of the hop holds (the first occurrence stays), that
//     the pool holds, or that the lossy two-probe visited table holds (the
//     reference's hash, size and insert: each slot computed against the
//     table before this hop's inserts, the later id winning a shared slot);
//     score the rest and fold them into the pool.
// Scoring is score.cuh's rows_d2, the gather kernels' row_d2 order: the
// kernel path sums as the per-hop kernels did.  The fresh list is ordered
// by gather_topk's (dist, position) key: each valid key's rank is the count
// of smaller keys (one barrier; a bitonic sort of the 128 keys of a bw-4
// hop would take 28), and the keys of rank < min(F, ef) are kept at every
// F, where the reference leaves its top-k kernel past 128.  The fold is a
// stable bounded merge: each pool entry moves down by the fresh keys
// strictly below it, each fresh key by the pool entries at or below it, so
// pool entries win distance ties.  It equals the reference's stable sort of
// pool + fresh (bw 1) and _merge_sorted (bw > 1) once the entry pool is
// stably sorted, which the host does before the launch.
//
// What bounds it on an H100: neither bytes nor operations but the latency
// of dependent hops.  A hop at ef = 64, m = 32, d = 128 scores at most 32
// rows (16 KB of f32) and 4 B·m-id rows: a few hundred nanoseconds of the
// card's bandwidth, far below the chain a hop waits on (the node's
// neighbour-id row, then the visited words, then the neighbour rows, each a
// round trip to L2 or HBM, plus about eight block barriers).  Tensor cores
// have no role: one query per block makes every hop a matrix-vector
// product.  So the design cuts round trips and host work: the hop loop
// never returns to the host (no launch, no sync, no torch op per hop);
// within a hop every lane issues its loads of all the block's rows before
// any reduction (32 warps, one row each at m = 32, four each at
// B·m = 128), so a hop waits on about one row round trip; the pool, the
// fresh keys, the query and the visited table live in shared memory.
// With the serving batch of 64, 64 of the 132 SMs hold a block and the
// rest idle; the batch size is the serving default and is not widened.
//
// Shared memory: kernels/beam.py::beam_plan owns the layout and passes its
// byte offsets (Layout below); the launcher checks that they are ascending,
// 16-aligned, hold what the kernel stores and fit the card.  The plan puts
// the query and the scale (2·4d bytes), the control ints, B selected
// positions, 7 arrays of F = B·m fresh entries (4·F each, the keys 8·F),
// the bw > 1 table 4·(H+1) (H <= 8192: at most 32 KB), and two pool
// buffers of ef (distance, id, expanded) each, 2·(4·ef + 4·ef + ef)
// rounded: 18·ef.  At d = 128, m = 32 the pool stays in shared memory up
// to ef = 12,784 (bw 1) and ef = 10,792 (bw 4); past the 227 KB a block
// may hold, the two pool buffers live in a global scratch row of the same
// kernel (pool_global).
// The visited set of bw 1 is a bitmap of n+1 bits per query in global
// memory (read through L2 with __ldcg, set with atomicOr).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "corpus.cuh"
#include "score.cuh"
#include "topk_key.cuh"

#define BEAM_THREADS 1024
#define BEAM_WARPS (BEAM_THREADS / 32)
#define ROWS 4  // rows one warp scores at once
#define CTL_NV 40  // fresh entries that passed every check this hop
#define CTL_NEED (CTL_NV + 1)  // control ints: 33 scan words, then CTL_NV
#define FULL 0xffffffffu

static_assert(BEAM_WARPS == 32, "first_selectable scans one warp total each");

// Byte offsets into a block's dynamic shared memory, in the order of
// kernels/beam.py::LAYOUT: the regions, the total, and within one pool
// buffer the ids, the expanded flags and the buffer's size.
struct Layout {
  long long q, scale, ctl, sel, fid, fok, fv, slot, sd, sid, fkey, table,
      pool, total, pool_id, pool_e, pool_buf;
};
static_assert(sizeof(Layout) == 17 * sizeof(long long), "LAYOUT's 17 fields");

struct Pool {
  float* d;
  int* id;
  uint8_t* e;
};

__device__ __forceinline__ Pool pool_at(unsigned char* base,
                                        const Layout& L) {
  Pool p;
  p.d = reinterpret_cast<float*>(base);
  p.id = reinterpret_cast<int*>(base + L.pool_id);
  p.e = base + L.pool_e;
  return p;
}

struct BeamArgs {
  const void* x;
  const float* scale;
  const int* nbrs;
  const float* q;
  const int* lo;
  const int* hi;
  const int* seeds;  // (Q, E) entry ids to mark visited, -1 = none
  const float* init_d;  // (Q, ef) the entry pool, stably sorted
  const int* init_id;
  const uint8_t* init_e;
  float* out_d;  // (Q, ef) the final pool
  int* out_id;
  int* out_steps;  // (Q,)
  int* out_ndist;
  uint32_t* visited;  // bw 1: (Q, W) zeroed words
  unsigned char* pool;  // pool_global: (Q, 2 * L.pool_buf)
  int d, m, E, ef, B, F, H, W, steps_cap, early_stop, pool_global;
  Layout L;
};

__device__ __forceinline__ float f_inf() { return __uint_as_float(INF_BITS); }

// The reference's two probe slots of an id in a table of 2^bits slots:
// the uint32 multiply-shift (kernels/ref.py::hash_slots).
__device__ __forceinline__ int hash_slot(int id, uint32_t mult, int bits) {
  return (int)(((uint32_t)id * mult) >> (32 - bits));
}
#define HASH1 2654435761u
#define HASH2 2246822519u

// The first `want` positions of the sorted pool that hold an unexpanded
// finite candidate, ascending, into out[]; returns how many (<= want), the
// same in every thread.  ws: 33 ints.  Ends with a barrier.
__device__ int first_selectable(const Pool& P, int ef, int want, int* out,
                                int* ws) {
  const float inf = f_inf();
  const int per = (ef + BEAM_THREADS - 1) / BEAM_THREADS;
  const int p0 = min((int)threadIdx.x * per, ef);
  const int p1 = min(p0 + per, ef);
  int cnt = 0;
  for (int p = p0; p < p1; ++p) cnt += (!P.e[p] && P.d[p] < inf);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = ws[lane];
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += u;
    }
    ws[lane] = inc - v;
    if (lane == 31) ws[32] = inc;
  }
  __syncthreads();
  int rank = ws[warp] + incl - cnt;
  for (int p = p0; p < p1 && rank < want; ++p)
    if (!P.e[p] && P.d[p] < inf) out[rank++] = p;
  const int total = ws[32];
  __syncthreads();
  return min(total, want);
}

// Scores the fresh entries i < F with ok[i] into keys (dist, i), KEY_NONE
// for the others: warp w takes rows w, w + 32, w + 64, w + 96, ... ROWS at
// a time.
template <typename T>
__device__ void score_fresh(const T* __restrict__ x, const float* ss,
                            const float* qs, int d, const int* fid,
                            const int* ok, key_t64* fkey, int F) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = warp; base < F; base += BEAM_WARPS * ROWS) {
    const T* xr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = base + r * BEAM_WARPS;
      xr[r] = (i < F && ok[i]) ? x + (size_t)fid[i] * d : nullptr;
    }
    float s[ROWS];
    rows_d2<T, ROWS>(xr, ss, qs, d, lane, s);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = base + r * BEAM_WARPS;
        if (i < F)
          fkey[i] = xr[r] != nullptr ? make_key(s[r], (uint32_t)i) : KEY_NONE;
      }
    }
  }
}

// The valid fresh keys of rank < keep, ascending by (dist, position), as
// distances sd[] and ids sid[].  Ends with a barrier.
__device__ void rank_fresh(const key_t64* fkey, const int* fid, int F,
                           int keep, float* sd, int* sid) {
  for (int j = threadIdx.x; j < F; j += BEAM_THREADS) {
    const key_t64 kj = fkey[j];
    if (kj == KEY_NONE) continue;
    int r = 0;
    for (int i = 0; i < F; ++i) r += fkey[i] < kj;
    if (r < keep) {
      sd[r] = key_dist(kj);
      sid[r] = fid[j];
    }
  }
  __syncthreads();
}

// The best ef of the sorted pool A and the nf fresh entries (sd ascending)
// into B, pool entries winning distance ties; fresh entries come in
// unexpanded.  Ends with a barrier.
__device__ void merge_pool(const Pool& A, const Pool& B, int ef,
                           const float* sd, const int* sid, int nf) {
  for (int i = threadIdx.x; i < ef; i += BEAM_THREADS) {
    const float d = A.d[i];
    int lo = 0, hi = nf;  // fresh entries strictly closer
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sd[mid] < d) lo = mid + 1;
      else hi = mid;
    }
    const int np = i + lo;
    if (np < ef) {
      B.d[np] = d;
      B.id[np] = A.id[i];
      B.e[np] = A.e[i];
    }
  }
  for (int r = threadIdx.x; r < nf; r += BEAM_THREADS) {
    const float d = sd[r];
    int lo = 0, hi = ef;  // pool entries at or below d
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (A.d[mid] <= d) lo = mid + 1;
      else hi = mid;
    }
    const int np = r + lo;
    if (np < ef) {
      B.d[np] = d;
      B.id[np] = sid[r];
      B.e[np] = 0;
    }
  }
  __syncthreads();
}

template <typename T, bool BATCHED>
__global__ void __launch_bounds__(BEAM_THREADS, 1) beam_kernel(BeamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d = a.d, m = a.m, ef = a.ef, F = a.F, H = a.H;
  const Layout L = a.L;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ss =
      a.scale != nullptr ? reinterpret_cast<float*>(smem + L.scale) : nullptr;
  int* ctl = reinterpret_cast<int*>(smem + L.ctl);
  int* sel = reinterpret_cast<int*>(smem + L.sel);
  int* fid = reinterpret_cast<int*>(smem + L.fid);
  int* fok = reinterpret_cast<int*>(smem + L.fok);
  int* fv = reinterpret_cast<int*>(smem + L.fv);
  int* slot = reinterpret_cast<int*>(smem + L.slot);
  float* sd = reinterpret_cast<float*>(smem + L.sd);
  int* sid = reinterpret_cast<int*>(smem + L.sid);
  key_t64* fkey = reinterpret_cast<key_t64*>(smem + L.fkey);
  int* table = reinterpret_cast<int*>(smem + L.table);
  unsigned char* pbase =
      a.pool_global ? a.pool + (size_t)qi * 2 * L.pool_buf : smem + L.pool;
  Pool cur = pool_at(pbase, L);
  Pool nxt = pool_at(pbase + L.pool_buf, L);
  const T* x = static_cast<const T*>(a.x);
  uint32_t* vis = BATCHED ? nullptr : a.visited + (size_t)qi * a.W;
  const int lo = a.lo[qi], hi = a.hi[qi];
  const int bits = H ? 31 - __clz(H) : 0;
  const float inf = f_inf();

  for (int c = tid; c < d; c += BEAM_THREADS) {
    qs[c] = a.q[(size_t)qi * d + c];
    if (ss != nullptr) ss[c] = a.scale[c];
  }
  for (int i = tid; i < ef; i += BEAM_THREADS) {
    cur.d[i] = a.init_d[(size_t)qi * ef + i];
    cur.id[i] = a.init_id[(size_t)qi * ef + i];
    cur.e[i] = a.init_e[(size_t)qi * ef + i];
  }
  if (BATCHED) {
    for (int i = tid; i <= H; i += BEAM_THREADS) table[i] = -1;
    __syncthreads();
    // the entries' insert into the empty table: each at its first probe,
    // the later entry winning a shared slot
    if (warp == 0) {
      for (int c0 = 0; c0 < a.E; c0 += 32) {
        const int i = c0 + lane;
        const int id = i < a.E ? a.seeds[(size_t)qi * a.E + i] : -1;
        const int s = id >= 0 ? hash_slot(id, HASH1, bits) : -1 - lane;
        const unsigned same = __match_any_sync(FULL, s);
        if (id >= 0 && lane == 31 - __clz(same)) table[s] = id;
        __syncwarp();
      }
    }
  } else {
    for (int i = tid; i < a.E; i += BEAM_THREADS) {
      const int s = a.seeds[(size_t)qi * a.E + i];
      if (s >= 0) atomicOr(vis + (s >> 5), 1u << (s & 31));
    }
  }
  __syncthreads();

  int steps = 0, ndist = 0;
  const int want = BATCHED ? a.B : 1;
  for (;;) {
    if (tid == 0) ctl[CTL_NV] = 0;
    const int ns = first_selectable(cur, ef, want, sel, ctl);
    // the reference's loop condition: best unexpanded <= worst held
    const float best = ns ? cur.d[sel[0]] : inf;
    const float worst = cur.d[ef - 1];
    bool go = best <= worst && steps < a.steps_cap;
    if (a.early_stop) go = go && best < inf;
    if (!go) break;

    if (!BATCHED) {
      // first minimum of the unexpanded distances, position 0 if all +inf
      const int bi = ns ? sel[0] : 0;
      const int node = max(cur.id[bi], 0);
      for (int j = tid; j < m; j += BEAM_THREADS) {
        const int id = __ldg(a.nbrs + (size_t)node * m + j);
        bool ok = id >= 0 && id >= lo && id <= hi;
        if (ok) ok = !((__ldcg(vis + (id >> 5)) >> (id & 31)) & 1u);
        fid[j] = id;
        fok[j] = ok;
        if (ok) atomicAdd(ctl + CTL_NV, 1);
      }
      if (tid == 0) cur.e[bi] = 1;
      __syncthreads();
      // the whole row was read before any of it is marked
      for (int j = tid; j < m; j += BEAM_THREADS)
        if (fok[j]) atomicOr(vis + (fid[j] >> 5), 1u << (fid[j] & 31));
      score_fresh(x, ss, qs, d, fid, fok, fkey, F);
    } else {
      for (int b = tid; b < ns; b += BEAM_THREADS) cur.e[sel[b]] = 1;
      for (int i = tid; i < F; i += BEAM_THREADS) {
        const int b = i / m;
        const int node = b < ns ? cur.id[sel[b]] : -1;
        const int id =
            node >= 0 ? __ldg(a.nbrs + (size_t)node * m + (i - b * m)) : -1;
        fid[i] = id;
        fok[i] = node >= 0 && id >= 0 && id >= lo && id <= hi;
      }
      __syncthreads();
      // dedup against the hop, the pool and the table, all as they were
      // before this hop's inserts; the insert slot against the same table
      for (int i = warp; i < F; i += BEAM_WARPS) {
        if (!fok[i]) {  // warp-uniform
          if (lane == 0) fv[i] = 0;
          continue;
        }
        const int id = fid[i];
        bool hit = false;
        for (int j = lane; j < i; j += 32) hit |= fok[j] && fid[j] == id;
        for (int e = lane; e < ef; e += 32) hit |= cur.id[e] == id;
        hit = __any_sync(FULL, hit);
        if (lane == 0) {
          const int h1 = hash_slot(id, HASH1, bits);
          const int h2 = hash_slot(id, HASH2, bits);
          const int c1 = table[h1];
          hit = hit || c1 == id || table[h2] == id;
          fv[i] = !hit;
          slot[i] = (c1 == -1 || c1 == id) ? h1 : h2;
          if (!hit) atomicAdd(ctl + CTL_NV, 1);
        }
      }
      __syncthreads();
      // the insert, in hop order: the later id of a shared slot wins
      if (warp == 0) {
        for (int c0 = 0; c0 < F; c0 += 32) {
          const int i = c0 + lane;
          const bool ok = i < F && fv[i];
          const int s = ok ? slot[i] : -1 - lane;
          const unsigned same = __match_any_sync(FULL, s);
          if (ok && lane == 31 - __clz(same)) table[s] = fid[i];
          __syncwarp();
        }
      }
      score_fresh(x, ss, qs, d, fid, fv, fkey, F);
    }
    __syncthreads();
    const int nf = ctl[CTL_NV];
    const int keep = min(F, ef);
    rank_fresh(fkey, fid, F, keep, sd, sid);
    merge_pool(cur, nxt, ef, sd, sid, min(nf, keep));
    const Pool t = cur;
    cur = nxt;
    nxt = t;
    ++steps;
    ndist += nf;
  }
  for (int i = tid; i < ef; i += BEAM_THREADS) {
    a.out_d[(size_t)qi * ef + i] = cur.d[i];
    a.out_id[(size_t)qi * ef + i] = cur.id[i];
  }
  if (tid == 0) {
    a.out_steps[qi] = steps;
    a.out_ndist[qi] = ndist;
  }
}

// Whether the plan's layout holds what the kernel stores and fits the
// card's opt-in shared memory per block.
static bool layout_ok(const BeamArgs& a) {
  const Layout& L = a.L;
  const long long o[] = {L.q,  L.scale, L.ctl, L.sel,  L.fid,   L.fok, L.fv,
                         L.slot, L.sd,  L.sid, L.fkey, L.table, L.pool,
                         L.total};
  for (int i = 0; i < (int)(sizeof(o) / sizeof(o[0])); ++i)
    if (o[i] % 16 || (i && o[i] < o[i - 1])) return false;
  const long long F4 = 4LL * a.F;
  const bool fits =
      L.scale - L.q >= 4LL * a.d && L.ctl - L.scale >= 4LL * a.d &&
      L.sel - L.ctl >= 4LL * CTL_NEED && L.fid - L.sel >= 4LL * a.B &&
      L.fok - L.fid >= F4 && L.fv - L.fok >= F4 && L.slot - L.fv >= F4 &&
      L.sd - L.slot >= F4 && L.sid - L.sd >= F4 && L.fkey - L.sid >= F4 &&
      L.table - L.fkey >= 8LL * a.F &&
      L.pool - L.table >= (a.H ? 4LL * (a.H + 1) : 0) &&
      L.total - L.pool >= (a.pool_global ? 0 : 2 * L.pool_buf) &&
      L.pool_id % 16 == 0 && L.pool_id >= 4LL * a.ef &&
      L.pool_e - L.pool_id >= 4LL * a.ef &&
      L.pool_buf - L.pool_e >= a.ef && L.pool_buf % 16 == 0;
  int dev = 0, optin = 0;
  if (!fits || cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev))
    return false;
  return L.total <= optin;
}

template <typename T, bool BATCHED>
static int launch(const BeamArgs& a, int Q, cudaStream_t st) {
  if (!layout_ok(a)) return (int)cudaErrorInvalidValue;
  const int rc = set_smem((const void*)beam_kernel<T, BATCHED>, a.L.total);
  if (rc) return rc;
  beam_kernel<T, BATCHED><<<Q, BEAM_THREADS, a.L.total, st>>>(a);
  return (int)cudaGetLastError();
}

static BeamArgs pack(const void* x, const float* scale, const int* nbrs,
                     const float* q, const int* lo, const int* hi,
                     const int* seeds, const float* init_d,
                     const int* init_id, const uint8_t* init_e, float* out_d,
                     int* out_id, int* out_steps, int* out_ndist,
                     uint32_t* visited, unsigned char* pool, int d, int m,
                     int E, int ef, int B, int H, int W, int steps_cap,
                     int early_stop, int pool_global,
                     const long long* layout) {
  BeamArgs a;
  a.x = x;
  a.scale = scale;
  a.nbrs = nbrs;
  a.q = q;
  a.lo = lo;
  a.hi = hi;
  a.seeds = seeds;
  a.init_d = init_d;
  a.init_id = init_id;
  a.init_e = init_e;
  a.out_d = out_d;
  a.out_id = out_id;
  a.out_steps = out_steps;
  a.out_ndist = out_ndist;
  a.visited = visited;
  a.pool = pool;
  a.d = d;
  a.m = m;
  a.E = E;
  a.ef = ef;
  a.B = B;
  a.F = B * m;
  a.H = H;
  a.W = W;
  a.steps_cap = steps_cap;
  a.early_stop = early_stop;
  a.pool_global = pool_global;
  memcpy(&a.L, layout, sizeof(Layout));
  return a;
}

#define BEAM_PARAMS                                                          \
  const void *x, int dtype, const float *scale, const int *nbrs,            \
      const float *q, const int *lo, const int *hi, const int *seeds,       \
      const float *init_d, const int *init_id, const uint8_t *init_e,       \
      float *out_d, int *out_id, int *out_steps, int *out_ndist,            \
      uint32_t *visited, unsigned char *pool, int Q, int d, int m, int E,   \
      int ef, int B, int H, int W, int steps_cap, int early_stop,           \
      int pool_global, const long long *layout, void *stream
#define BEAM_PACK                                                            \
  pack(x, scale, nbrs, q, lo, hi, seeds, init_d, init_id, init_e, out_d,    \
       out_id, out_steps, out_ndist, visited, pool, d, m, E, ef, B, H, W,   \
       steps_cap, early_stop, pool_global, layout)

// bw 1: B = 1, H = 0, visited (Q, W) zeroed 32-bit words (W >= (n+32)/32).
// x: (N, d) elements of `dtype` (DT_F32, DT_INT8 or DT_BF16); scale: (d,)
// f32 or null.  Returns the first CUDA error, 0 on success.
extern "C" int beam_single_launch(BEAM_PARAMS) {
  if (B != 1 || H != 0 || visited == nullptr)
    return (int)cudaErrorInvalidValue;
  const BeamArgs a = BEAM_PACK;
  int rc = 0;
  DISPATCH_CORPUS(dtype, T, {
    rc = launch<T, false>(a, Q, (cudaStream_t)stream);
  });
  return rc;
}

// bw > 1: B = min(bw, ef) expansions per hop, H the table's slots (a power
// of two of at least 256); visited unused.
extern "C" int beam_batched_launch(BEAM_PARAMS) {
  if (B < 1 || H < 256 || (H & (H - 1))) return (int)cudaErrorInvalidValue;
  const BeamArgs a = BEAM_PACK;
  int rc = 0;
  DISPATCH_CORPUS(dtype, T, {
    rc = launch<T, true>(a, Q, (cudaStream_t)stream);
  });
  return rc;
}
