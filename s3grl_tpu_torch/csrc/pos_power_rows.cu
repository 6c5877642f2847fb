// PoS operator rows for a batch of padded subgraphs, on Hopper (sm_90a).
//
// Replaces the TPU kernel s3grl_tpu/ops/pos_pallas.py::pos_power_rows.
// For each subgraph b it returns the R selected rows of Â^k X, k = 0..K,
// where A is densified from a padded neighbor table,
//     A[j, s] += w[s, d]  wherever  nbr[s, d] == row_ids[j],
// and Â = diag(rowdeg)^-1/2 A diag(coldeg)^-1/2 (a zero degree gives 0).
//
// The TPU kernel keeps a dense [S, S] plane on chip. Here nothing is
// densified: the selected rows are carried as H_k = H_{k-1} Â in the gather
// form of the same product, exact for any table, symmetric or not:
//     loc(s, d)  = the slot j with row_ids[j] == nbr[s, d] (none if absent)
//     coldeg[s]  = sum_d w[s,d] [loc(s,d) exists]
//     rowdeg[j]  = sum_{(s,d): loc(s,d) = j} w[s,d]
//     ŵ(s, d)    = w[s,d] rowdeg[loc]^-1/2 coldeg[s]^-1/2
//     H_k[r, s]  = sum_d ŵ(s, d) H_{k-1}[r, loc(s, d)]     (H_0 = one-hot of sel)
//     out[k, r, :] = sum_s H_k[r, s] X[s, :]
//
// What bounds it on an H100: bytes. At R = 2 a subgraph of S = 256 nodes
// does about 3 MFLOP against 1 MB of features X (F = 1,026) and 0.2 MB of
// table; PoS+ (R = 34) does 17 times the FLOP on the same bytes and is bound
// by the f32 FMA rate. Two launches on one stream:
//
// 1. pos_selector_rows_kernel, one block of 512 threads per subgraph. It
//    reads the table once: a warp per source row s reads the row coalesced
//    (four 32-entry chunks in flight), skips zero weights, resolves each id
//    once (an open-addressing hash table of the row ids in shared memory,
//    built by the block first; the TPU kernel compares every id with every
//    row) and appends the row's resolved entries (slot, w) to a compact list
//    grouped by s. The list lives in shared memory up to `cap` entries and spills
//    past that into a global scratch region of its subgraph. The same pass
//    sums coldeg (per warp, in a fixed order) and rowdeg (shared-memory
//    atomics: its last bits can vary from run to run where weights are not
//    small integers; with the 0/1 weights of an unweighted graph the sums are
//    exact). The entries are then scaled once to ŵ, and the K steps walk the
//    list, 8 lanes to a row and 2 or 8 selector rows to an item (R <= 2 or
//    not): no table reads, no searches. H_k goes to the scratch tensor
//    h [B, S, KRP], row c = (k-1)·R + r of the selector at h[b, s, c], the
//    columns KR..KRP-1 zero (KRP = KR rounded up to 8). Step k reads H_{k-1}
//    from shared memory where two [S, R] buffers fit, else back from h,
//    which this block has just written (L1 and L2 hits).
// 2. The X pass reads X once for all (k, r) pairs, with f32 FMA (no TF32),
//    in one of two kernels chosen by K·R:
//    - K·R <= 32 (PoS, R = 2: bound by bytes): pos_xpass_kernel streams X.
//      A warp owns a tile of 32·VEC·2 columns of one subgraph and 8 selector
//      rows, walks s = 0..S-1 reading X's row s coalesced (float2 where F is
//      even) and the 8 H values of row s (two float4, the same address in
//      every lane), eight rows s in flight, and keeps an 8 × 2·VEC tile of
//      sums in registers. Where there are more row groups than a block's 4
//      warps, the blocks of one column tile run next to each other, so X
//      comes from device memory once and from L2 after.
//    - K·R > 32 (PoS+, KR = 102: bound by the FMA rate):
//      pos_xpass_tiled_kernel, a register-tiled product H^T X with both
//      operands staged in shared memory by cp.async (see there).
//    Both also copy out[0] = X[sel]. The ragged last column tile (1,026 =
//    8·128 + 2) is one more block with the columns past F masked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads1 = 512;
constexpr int kWarps1 = kThreads1 / 32;
constexpr int kChunks = 4;     // 32-entry chunks of a table row loaded together
constexpr int kGroup = 8;      // lanes that share one row's entries
constexpr int kListCap = 4096; // compact entries kept in shared memory (32 KB)
constexpr int kRT = 8;         // selector rows per warp in the X pass
constexpr int kNV = 2;         // column chunks per lane in the X pass
constexpr int kMaxRowGroupsPerBlock = 4;
constexpr int kThreads2 = 128;  // the most threads of an X-pass block
constexpr unsigned kFull = 0xffffffffu;

// Slots of the subgraph's row ids in an open-addressing hash table in shared
// memory: keys [T] (-1 = empty) and slots [T], T = 2^log_t >= 2S, so the
// table is at most half full.
__device__ __forceinline__ int hash_of(int id, int log_t) {
  return static_cast<int>((static_cast<unsigned>(id) * 2654435761u) >> (32 - log_t));
}

// Slot of each of kChunks ids (-1 where absent or where `live` is false).
// The first probes of all kChunks ids are issued together.
__device__ __forceinline__ void resolve(const int (&id)[kChunks], const bool (&live)[kChunks],
                                        const int* hkeys, const int* hslots, int S,
                                        bool has_ids, int log_t, int (&l)[kChunks]) {
  if (!has_ids) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) l[c] = live[c] && id[c] >= 0 && id[c] < S ? id[c] : -1;
    return;
  }
  const int mask = (1 << log_t) - 1;
  int pos[kChunks], key[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    pos[c] = hash_of(id[c], log_t);
    key[c] = live[c] && id[c] >= 0 ? hkeys[pos[c]] : -1;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    l[c] = -1;
    if (!live[c] || id[c] < 0) continue;
    while (key[c] != id[c] && key[c] != -1) {
      pos[c] = (pos[c] + 1) & mask;
      key[c] = hkeys[pos[c]];
    }
    if (key[c] == id[c]) l[c] = hslots[pos[c]];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Entry i of the compact list: shared memory below cap, the spill above.
__device__ __forceinline__ int2* entry(int2* list, int2* spill, int cap, int i) {
  return i < cap ? list + i : spill + (i - cap);
}

// kRowChunk: selector rows per propagation item (2 where R <= 2, else 8).
template <int kRowChunk>
__global__ void __launch_bounds__(kThreads1)
pos_selector_rows_kernel(const int* __restrict__ sel,      // [B, R]
                         const int* __restrict__ nbr,      // [B, S, D]
                         const float* __restrict__ w,      // [B, S, D]
                         const int* __restrict__ row_ids,  // [B, S] or null (slot iota)
                         float* h,                         // [B, S, KRP], read back
                         int2* __restrict__ spill_all,     // [B, S*D - cap] or null
                         int S, int D, int R, int K, int KRP, int cap, int log_t,
                         int h_in_smem) {
  extern __shared__ int4 smem_i4[];
  const bool has_ids = row_ids != nullptr;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_hash = has_ids ? 1 << log_t : 0;

  int2* list = reinterpret_cast<int2*>(smem_i4);      // [cap] (slot, w or ŵ)
  int2* stage = list + cap;                           // [kWarps1, D]
  float* rdeg = reinterpret_cast<float*>(stage + kWarps1 * D);  // [S]
  float* cdeg = rdeg + S;                             // [S]
  int* rstart = reinterpret_cast<int*>(cdeg + S);     // [S] first entry of row s
  int* rcnt = rstart + S;                             // [S] entries of row s
  int* sel_s = rcnt + S;                              // [R]
  int* total = sel_s + R;                             // [1]
  int* hkeys = total + 1;                             // [n_hash] row ids, -1 empty
  int* hslots = hkeys + n_hash;                       // [n_hash]
  float* hs = reinterpret_cast<float*>(hslots + n_hash);  // [2, S, R] when h_in_smem

  const int64_t tab = static_cast<int64_t>(b) * S * D;
  const int* nbr_b = nbr + tab;
  const float* w_b = w + tab;
  int2* spill = spill_all != nullptr
                    ? spill_all + static_cast<int64_t>(b) * (static_cast<int64_t>(S) * D - cap)
                    : nullptr;
  float* h_b = h + static_cast<int64_t>(b) * S * KRP;
  const int KR = K * R;

  for (int i = tid; i < S; i += kThreads1) rdeg[i] = 0.f;
  for (int i = tid; i < n_hash; i += kThreads1) hkeys[i] = -1;
  for (int r = tid; r < R; r += kThreads1) sel_s[r] = sel[static_cast<int64_t>(b) * R + r];
  if (tid == 0) *total = 0;
  const int pad = KRP - KR;  // zero columns of h
  for (int i = tid; i < S * pad; i += kThreads1) h_b[(i / pad) * KRP + KR + i % pad] = 0.f;
  __syncthreads();
  if (has_ids) {  // row ids are unique, so each one claims its own cell
    for (int j = tid; j < S; j += kThreads1) {
      const int id = row_ids[static_cast<int64_t>(b) * S + j];
      if (id < 0) continue;
      for (int p = hash_of(id, log_t);; p = (p + 1) & (n_hash - 1)) {
        if (atomicCAS(&hkeys[p], -1, id) == -1) {
          hslots[p] = j;
          break;
        }
      }
    }
    __syncthreads();
  }

  // The one pass over the table: a warp per source row s, kChunks chunks of
  // the row loaded at once.
  int2* st = stage + warp * D;
  for (int s = warp; s < S; s += kWarps1) {
    int n = 0;
    float cd = 0.f;
    const int* nrow = nbr_b + static_cast<int64_t>(s) * D;
    const float* wrow = w_b + static_cast<int64_t>(s) * D;
    for (int d0 = 0; d0 < D; d0 += 32 * kChunks) {
      int id[kChunks], l[kChunks];
      float wt[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = d0 + c * 32 + lane;
        wt[c] = d < D ? wrow[d] : 0.f;
        id[c] = d < D ? nrow[d] : -1;
      }
      bool live[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) live[c] = wt[c] != 0.f;
      resolve(id, live, hkeys, hslots, S, has_ids, log_t, l);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        if (d0 + c * 32 >= D) break;  // the same in every lane
        const unsigned hit = __ballot_sync(kFull, l[c] >= 0);
        if (l[c] >= 0) {
          st[n + __popc(hit & ((1u << lane) - 1u))] = make_int2(l[c], __float_as_int(wt[c]));
          cd += wt[c];
          atomicAdd(&rdeg[l[c]], wt[c]);
        }
        n += __popc(hit);
      }
    }
    cd = warp_sum(cd);
    int off = 0;
    if (lane == 0) {
      off = atomicAdd(total, n);
      rstart[s] = off;
      rcnt[s] = n;
      cdeg[s] = cd;
    }
    off = __shfl_sync(kFull, off, 0);
    __syncwarp();
    for (int i = lane; i < n; i += 32) *entry(list, spill, cap, off + i) = st[i];
    __syncwarp();
  }
  __syncthreads();
  for (int i = tid; i < S; i += kThreads1) {
    rdeg[i] = rdeg[i] > 0.f ? rsqrtf(rdeg[i]) : 0.f;
    cdeg[i] = cdeg[i] > 0.f ? rsqrtf(cdeg[i]) : 0.f;
  }
  __syncthreads();

  // From here on a group of kGroup lanes shares each row's entries, so a
  // long row (a hub) takes 1/kGroup of the steps it would alone.
  const int q = lane % kGroup;
  const int n_groups = kThreads1 / kGroup;
  // Scale each entry once: ŵ = w rowdeg[l]^-1/2 coldeg[s]^-1/2.
  for (int s = tid / kGroup; s < S; s += n_groups) {
    const float c = cdeg[s];
    for (int i = rstart[s] + q, e = rstart[s] + rcnt[s]; i < e; i += kGroup) {
      int2* p = entry(list, spill, cap, i);
      const int2 v = *p;
      p->y = __float_as_int((__int_as_float(v.y) * rdeg[v.x]) * c);
    }
  }
  __syncthreads();

  // Propagation: item (s, chunk of kRowChunk selector rows) per group; each
  // lane sums every kGroup-th entry of row s, and the group's sums are added
  // in a fixed tree. H_{k-1} is read from shared memory ([S, R], two buffers
  // in turn) where it fits, else back from h.
  const int n_items = S * ((R + kRowChunk - 1) / kRowChunk);
  for (int k = 1; k <= K; ++k) {
    const float* src = h_in_smem ? hs + ((k - 1) & 1) * S * R : h_b + (k >= 2 ? (k - 2) * R : 0);
    const int ld = h_in_smem ? R : KRP;  // H_{k-1}[r, l] at src[l * ld + r]
    float* dst = h_in_smem ? hs + (k & 1) * S * R : nullptr;
    float* hk = h_b + (k - 1) * R;
    // it0 is the same in every lane of a warp, so the shuffles see all 32.
    for (int it0 = warp * (32 / kGroup); it0 < n_items; it0 += n_groups) {
      const int item = it0 + lane / kGroup;
      const bool act = item < n_items;
      const int s = act ? item % S : 0;
      const int r0 = act ? (item / S) * kRowChunk : R;
      float acc[kRowChunk];
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j) acc[j] = 0.f;
      const int e = act ? rstart[s] + rcnt[s] : 0;
#pragma unroll 2
      for (int i = (act ? rstart[s] : 0) + q; i < e; i += kGroup) {
        const int2 v = *entry(list, spill, cap, i);
        const float wn = __int_as_float(v.y);
#pragma unroll
        for (int j = 0; j < kRowChunk; ++j) {
          const int r = r0 + j;
          if (r < R) {
            const float prev = k == 1 ? (v.x == sel_s[r] ? 1.f : 0.f)
                                      : src[static_cast<int64_t>(v.x) * ld + r];
            acc[j] = fmaf(wn, prev, acc[j]);
          }
        }
      }
#pragma unroll
      for (int o = kGroup / 2; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < kRowChunk; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
      if (q == 0) {
#pragma unroll
        for (int j = 0; j < kRowChunk; ++j) {
          if (r0 + j < R) {
            hk[static_cast<int64_t>(s) * KRP + r0 + j] = acc[j];
            if (dst != nullptr) dst[s * R + r0 + j] = acc[j];
          }
        }
      }
    }
    __syncthreads();
  }
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
  __device__ static void store(float* p, const float* v) { p[0] = v[0]; }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* v) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

// Warps of a block: rg_blk row groups (of kRT selector rows) × sb subgraphs,
// all on one column tile. Block x is (row-group block z, column tile t,
// subgraph group), z fastest: the blocks that read the same X columns run
// next to each other, so X comes from device memory once and from L2 after.
template <int VEC>
__global__ void __launch_bounds__(kThreads2, 2)
pos_xpass_kernel(const int* __restrict__ sel,  // [B, R]
                 const float* __restrict__ x,  // [B, S, F]
                 const float* __restrict__ h,  // [B, S, KRP] or null when K = 0
                 float* __restrict__ out,      // [B, K+1, R, F]
                 int B, int S, int F, int R, int KR, int KRP, int rg_blk, int sb,
                 int nz, int n_tiles) {
  constexpr int kCols = kNV * VEC;  // columns a lane keeps
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int z = blockIdx.x % nz;
  const int t = (blockIdx.x / nz) % n_tiles;
  const int b = (blockIdx.x / nz / n_tiles) * sb + warp / rg_blk;
  if (b >= B) return;
  const int g = z * rg_blk + warp % rg_blk;
  const int col0 = t * (32 * kCols);
  const float* x_b = x + static_cast<int64_t>(b) * S * F;
  float* out_b = out + static_cast<int64_t>(b) * (KR + R) * F;

  int cols[kNV];
#pragma unroll
  for (int q = 0; q < kNV; ++q) cols[q] = col0 + q * 32 * VEC + lane * VEC;

  // Operator 0: the selected rows of X (0 for a row out of range).
  if (g == 0) {
    for (int r = 0; r < R; ++r) {
      const int row = sel[static_cast<int64_t>(b) * R + r];
      const bool in = row >= 0 && row < S;
#pragma unroll
      for (int q = 0; q < kNV; ++q) {
        if (cols[q] >= F) continue;
        float v[VEC];
        if (in) {
          Vec<VEC>::load(x_b + static_cast<int64_t>(row) * F + cols[q], v);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = 0.f;
        }
        Vec<VEC>::store(out_b + static_cast<int64_t>(r) * F + cols[q], v);
      }
    }
  }
  if (g * kRT >= KR) return;

  float acc[kRT][kCols];
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const float* h_b = h + static_cast<int64_t>(b) * S * KRP + g * kRT;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    float xv[kCols];
#pragma unroll
    for (int q = 0; q < kNV; ++q) {
      if (cols[q] < F) {
        Vec<VEC>::load(x_b + static_cast<int64_t>(s) * F + cols[q], xv + q * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xv[q * VEC + e] = 0.f;
      }
    }
    const float4 h0 = __ldg(reinterpret_cast<const float4*>(h_b + static_cast<int64_t>(s) * KRP));
    const float4 h1 = __ldg(reinterpret_cast<const float4*>(h_b + static_cast<int64_t>(s) * KRP + 4));
    const float hv[kRT] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int i = 0; i < kRT; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(hv[i], xv[j], acc[i][j]);
  }

#pragma unroll
  for (int i = 0; i < kRT; ++i) {
    const int c = g * kRT + i;
    if (c >= KR) break;
    float* o = out_b + static_cast<int64_t>(R + c) * F;
#pragma unroll
    for (int q = 0; q < kNV; ++q)
      if (cols[q] < F) Vec<VEC>::store(o + cols[q], acc[i] + q * VEC);
  }
}

// log2 of the hash table's size for S rows: the least power of two >= 2S.
int hash_log(int S) {
  int log_t = 1;
  while ((1 << log_t) < 2 * S) ++log_t;
  return log_t;
}

// The X pass where K·R > kTiledRows (PoS+): a block computes a tile of up
// to kTM·16 = 128 selector rows × kTN = 128 columns of one subgraph. Stages
// of kTS = 16 rows s of H (zero past KRP) and of X (zero past F) are copied
// into shared memory by cp.async, two stages in flight; each of 256 threads
// keeps an 8 × 8 tile of sums (rows ty·8.., columns tx·4.. and
// 64 + tx·4..), 64 FMA per four 16-byte shared-memory reads. (Blocks of
// KRP / 8 row threads, with no rows of zeros, ran slower on an H100.)
// grid = (column tiles × row blocks, B).
constexpr int kTiledRows = 32;
constexpr int kTM = 8, kTN = 128, kTS = 16, kTThreads = 256;
constexpr int kTRows = kTM * 16;  // selector rows of a block

// Copy `bytes` (4, 8 or 16) from global to shared memory asynchronously;
// where `live` is false, write zeros and read nothing.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = live ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(kBytes), "r"(n));
  }
}

template <int VEC>
__global__ void __launch_bounds__(kTThreads, 2)
pos_xpass_tiled_kernel(const int* __restrict__ sel,  // [B, R]
                       const float* __restrict__ x,  // [B, S, F]
                       const float* __restrict__ h,  // [B, S, KRP]
                       float* __restrict__ out,      // [B, K+1, R, F]
                       int S, int F, int R, int KR, int KRP, int n_tiles) {
  __shared__ __align__(16) float Hs[2][kTS][kTRows];
  __shared__ __align__(16) float Xs[2][kTS][kTN];
  constexpr int kCopiesH = kTS * kTRows / 4 / kTThreads;  // 16-byte copies of H a thread
  constexpr int kCopiesX = kTS * kTN / VEC / kTThreads;   // VEC-float copies of X a thread
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int t = blockIdx.x % n_tiles;
  const int row0 = (blockIdx.x / n_tiles) * kTRows;
  const int b = blockIdx.y;
  const int col0 = t * kTN;
  const float* x_b = x + static_cast<int64_t>(b) * S * F;
  const float* h_b = h + static_cast<int64_t>(b) * S * KRP;
  float* out_b = out + static_cast<int64_t>(b) * (KR + R) * F;

  if (row0 == 0) {  // operator 0: the selected rows of X (0 out of range)
    for (int i = tid; i < R * kTN; i += kTThreads) {
      const int r = i / kTN, col = col0 + i % kTN;
      const int row = sel[static_cast<int64_t>(b) * R + r];
      if (col < F)
        out_b[static_cast<int64_t>(r) * F + col] =
            row >= 0 && row < S ? x_b[static_cast<int64_t>(row) * F + col] : 0.f;
    }
  }

  auto stage = [&](int s0, int buf) {
#pragma unroll
    for (int q = 0; q < kCopiesH; ++q) {
      const int i = tid + q * kTThreads;
      const int ss = s0 + i / (kTRows / 4), c = row0 + (i % (kTRows / 4)) * 4;
      const bool live = ss < S && c < KRP;
      cp_async<16>(&Hs[buf][i / (kTRows / 4)][(i % (kTRows / 4)) * 4],
                   live ? h_b + static_cast<int64_t>(ss) * KRP + c : h_b, live);
    }
#pragma unroll
    for (int q = 0; q < kCopiesX; ++q) {
      const int i = tid + q * kTThreads;
      const int ss = s0 + i / (kTN / VEC), col = col0 + (i % (kTN / VEC)) * VEC;
      const bool live = ss < S && col < F;
      cp_async<4 * VEC>(&Xs[buf][i / (kTN / VEC)][(i % (kTN / VEC)) * VEC],
                        live ? x_b + static_cast<int64_t>(ss) * F + col : x_b, live);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_stages = (S + kTS - 1) / kTS;
  stage(0, 0);
  for (int st = 0; st < n_stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < n_stages) {
      stage((st + 1) * kTS, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTS; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Hs[buf][k][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Hs[buf][k][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Xs[buf][k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Xs[buf][k][64 + tx * 4]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();  // the buffer is refilled by the next stage's copies
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int c = row0 + ty * kTM + i;
    if (c >= KR) break;
    float* o = out_b + static_cast<int64_t>(R + c) * F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < F) o[col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Width KRP of the selector scratch h [B, S, KRP]: K·R rounded up to kRT.
int s3grl_pos_h_width(int R, int K) {
  const int kr = K * R;
  return kr > 0 ? (kr + kRT - 1) / kRT * kRT : kRT;
}

// Compact entries a block keeps in shared memory; the rest of its S·D
// possible entries go to the spill scratch [B, S·D − cap] int2.
int s3grl_pos_list_cap(int S, int D) {
  const int64_t sd = static_cast<int64_t>(S) * D;
  return static_cast<int>(sd < kListCap ? sd : kListCap);
}

// Bytes of dynamic shared memory the selector kernel needs, with H_{k-1}
// kept on chip (h_in_smem = 1) or read back from h (0).
int64_t s3grl_pos_selector_smem(int S, int D, int R, int has_ids, int cap, int h_in_smem) {
  int64_t bytes = 8 * (static_cast<int64_t>(cap) + static_cast<int64_t>(kWarps1) * D);
  bytes += 4 * (4 * static_cast<int64_t>(S) + R + 1);
  if (has_ids) bytes += 8 * (int64_t{1} << hash_log(S));
  if (h_in_smem) bytes += 8 * static_cast<int64_t>(S) * R;
  return bytes;
}

// Phase 1 on `stream`; returns the cudaError_t of the launch (0 = success).
int s3grl_pos_selector_rows(const int* sel, const int* nbr, const float* w,
                            const int* row_ids, float* h, void* spill, int B, int S,
                            int D, int R, int K, int cap, int h_in_smem,
                            int64_t smem_bytes, void* stream) {
  auto kernel = R <= 2 ? pos_selector_rows_kernel<2> : pos_selector_rows_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, kThreads1, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      sel, nbr, w, row_ids, h, static_cast<int2*>(spill), S, D, R, K,
      s3grl_pos_h_width(R, K), cap, hash_log(S), h_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// Phase 2 on `stream` (h may be null when K = 0); returns the cudaError_t.
int s3grl_pos_xpass(const int* sel, const float* x, const float* h, float* out,
                    int B, int S, int F, int R, int K, void* stream) {
  const int KRP = s3grl_pos_h_width(R, K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec2 = F % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (K * R > kTiledRows) {
    const int n_tiles = (F + kTN - 1) / kTN;
    const int64_t gx = static_cast<int64_t>(n_tiles) * ((KRP + kTRows - 1) / kTRows);
    if (gx > 0x7fffffff || B > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(static_cast<unsigned>(gx), B);
    if (vec2) {
      pos_xpass_tiled_kernel<2><<<grid, kTThreads, 0, s>>>(sel, x, h, out, S, F, R, K * R, KRP, n_tiles);
    } else {
      pos_xpass_tiled_kernel<1><<<grid, kTThreads, 0, s>>>(sel, x, h, out, S, F, R, K * R, KRP, n_tiles);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int rg = KRP / kRT;
  const int rg_blk = rg < kMaxRowGroupsPerBlock ? rg : kMaxRowGroupsPerBlock;
  const int sb = kMaxRowGroupsPerBlock / rg_blk;
  const int nz = (rg + rg_blk - 1) / rg_blk;
  const int cols_per_block = 32 * kNV * (vec2 ? 2 : 1);
  const int n_tiles = (F + cols_per_block - 1) / cols_per_block;
  const int64_t blocks = static_cast<int64_t>(nz) * n_tiles * ((B + sb - 1) / sb);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int threads = 32 * rg_blk * sb;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec2) {
    pos_xpass_kernel<2><<<grid, threads, 0, s>>>(sel, x, h, out, B, S, F, R, K * R, KRP,
                                                 rg_blk, sb, nz, n_tiles);
  } else {
    pos_xpass_kernel<1><<<grid, threads, 0, s>>>(sel, x, h, out, B, S, F, R, K * R, KRP,
                                                 rg_blk, sb, nz, n_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* s3grl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
