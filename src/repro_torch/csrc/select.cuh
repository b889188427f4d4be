// The threshold select shared by range_scan_select (range_scan.cu) and
// gather_rerank_select (gather_dist.cu): how a block keeps the k smallest
// packed (dist, index) keys (topk_key.cuh) of what it scores without
// sorting them.
//
// Each warp keeps a sorted list of k keys and its k-th key as a threshold;
// a scored key enters only if it beats the threshold, through a QCAP-key
// per-warp queue (ballot + popc slots).  A full queue is bitonic-sorted
// within the warp and merged into the list by rank (each key's place is
// its index plus a binary search in the other list), which also tightens
// the threshold.  The block folds its NWARPS warp lists in log2(NWARPS)
// pairwise rank merges.  Where one query's rows are split over several
// blocks of one launch, the last block to arrive merges their lists
// (finish_select).
//
// The includer defines NWARPS (warps per block, a power of two) and QCAP
// (the queue's keys, a power of two, 64 for a 32-lane network of pairs).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_key.cuh"

#if !defined(NWARPS) || !defined(QCAP)
#error "define NWARPS and QCAP before including select.cuh"
#endif

// Keys of s[0, n) (ascending) below v / at or below v.
__device__ __forceinline__ int count_below(const key_t64* s, int n,
                                           key_t64 v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
__device__ __forceinline__ int count_upto(const key_t64* s, int n,
                                          key_t64 v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The first k keys of the stable merge of a (na keys) and b (nb keys),
// both ascending, into out (a buffer apart from both), by one warp: a
// key's place is its index plus the keys of the other list before it (b's
// ties go after a's), so the places are a permutation and na + nb >= k
// fills out[0, k).
__device__ void warp_merge(const key_t64* a, int na, const key_t64* b,
                           int nb, key_t64* out, int k, int lane) {
  for (int i = lane; i < min(na, k); i += 32) {
    const key_t64 v = a[i];
    const int p = i + count_below(b, nb, v);
    if (p < k) out[p] = v;
  }
  for (int j = lane; j < min(nb, k); j += 32) {
    const key_t64 v = b[j];
    const int p = j + count_upto(a, na, v);
    if (p < k) out[p] = v;
  }
  __syncwarp();
}

// One warp's running top-k: a sorted list of k keys (in one of two
// buffers; the merge writes the other), its k-th key as the threshold, and
// a queue of keys that beat it.
struct WarpTopk {
  key_t64* list;
  key_t64* alt;
  key_t64* queue;
  key_t64 thr;
  int qc;
  int k;

  __device__ void reset(int lane) {
    for (int i = lane; i < k; i += 32) list[i] = KEY_NONE;
    thr = KEY_NONE;
    qc = 0;
    __syncwarp();
  }

  // Appends the keys of the lanes with `pass` set (qc + their count must
  // stay within QCAP).
  __device__ void push(bool pass, key_t64 key, int lane) {
    const unsigned m = __ballot_sync(0xffffffffu, pass);
    if (pass) queue[qc + __popc(m & ((1u << lane) - 1u))] = key;
    qc += __popc(m);
  }

  // Sorts the queue, merges it into the list, tightens the threshold.
  __device__ void flush(int lane) {
    for (int i = qc + lane; i < QCAP; i += 32) queue[i] = KEY_NONE;
    __syncwarp();
    for (int size = 2; size <= QCAP; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const int i = 2 * lane - (lane & (stride - 1));
        const key_t64 a = queue[i], b = queue[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          queue[i] = b;
          queue[i + stride] = a;
        }
        __syncwarp();
      }
    }
    warp_merge(list, k, queue, qc, alt, k, lane);
    key_t64* t = list;
    list = alt;
    alt = t;
    thr = list[k - 1];
    qc = 0;
  }
};

// Folds the NWARPS warp lists (warp w's in bufs + (2w + cur[w]) * k) into
// one, in log2(NWARPS) rounds of pairwise merges, each into the other
// buffer of its slot; returns the block's k best.  All threads call it.
__device__ const key_t64* block_merge(key_t64* bufs, int* cur, int k,
                                      int warp, int lane) {
  __syncthreads();
  for (int step = 1; step < NWARPS; step <<= 1) {
    const int s = warp * 2 * step;
    if (s + step < NWARPS) {
      const int cs = cur[s];
      warp_merge(bufs + (2 * s + cs) * k, k,
                 bufs + (2 * (s + step) + cur[s + step]) * k, k,
                 bufs + (2 * s + (cs ^ 1)) * k, k, lane);
      if (lane == 0) cur[s] = cs ^ 1;
    }
    __syncthreads();
  }
  return bufs + cur[0] * k;
}

// The end of a one-launch select whose query is split over S blocks (grid
// (Q, S), block (qi, c)), once the block has folded its warp lists into res
// (k sorted keys).  S = 1: the block emits res.  Else it writes res to
// partial (Q, S, k) and takes a ticket from arrivals[qi] (threadfence,
// atomicAdd); the last block of the query feeds the S sorted lists through
// top's threshold queue (a list is left at its first key that misses the
// threshold), merges, emits each key's index and distance to oi / od
// (-1/+inf pads), and sets the counter back to 0 for the next launch.  All
// threads call it, after a barrier; top is the warp's WarpTopk over its
// two list buffers in bufs.
__device__ __forceinline__ void finish_select(
    const key_t64* res, key_t64* bufs, int* cur, WarpTopk& top,
    key_t64* __restrict__ partial, int* arrivals, int qi, int c, int S,
    int k, int* __restrict__ oi, float* __restrict__ od, int warp,
    int lane) {
  __shared__ int last_s;
  if (S == 1) {
    for (int i = threadIdx.x; i < k; i += NWARPS * 32)
      emit(res[i], oi + i, od + i);
    return;
  }
  key_t64* mine = partial + ((size_t)qi * S + c) * k;
  for (int i = threadIdx.x; i < k; i += NWARPS * 32) mine[i] = res[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(arrivals + qi, 1) == S - 1;
  __syncthreads();
  if (!last_s) return;

  // the last block of the query: fold the S sorted chunk lists
  __threadfence();
  top.list = bufs + 2 * warp * k;
  top.alt = top.list + k;
  top.reset(lane);
  const key_t64* rows = partial + (size_t)qi * S * k;
  for (int cc = warp; cc < S; cc += NWARPS) {
    for (int off = 0; off < k; off += 32) {
      const key_t64 key =
          off + lane < k ? __ldcg(rows + (size_t)cc * k + off + lane)
                         : KEY_NONE;
      if (top.qc > QCAP - 32) top.flush(lane);
      const bool pass = key < top.thr;
      // a sorted list: past its first key that misses, all miss
      if (__ballot_sync(0xffffffffu, pass) != 0xffffffffu) {
        top.push(pass, key, lane);
        break;
      }
      top.push(pass, key, lane);
    }
  }
  if (top.qc > 0) top.flush(lane);
  if (lane == 0) cur[warp] = top.list == bufs + 2 * warp * k ? 0 : 1;
  res = block_merge(bufs, cur, k, warp, lane);
  for (int i = threadIdx.x; i < k; i += NWARPS * 32)
    emit(res[i], oi + i, od + i);
  if (threadIdx.x == 0) arrivals[qi] = 0;
}
