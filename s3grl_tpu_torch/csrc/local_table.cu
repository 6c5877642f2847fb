// Subgraph-local neighbor tables for a batch of node sets, on Hopper (sm_90a).
//
// No TPU counterpart: the JAX package builds this table on the host
// (s3grl_tpu/native/graphcore.cpp, gc_khop_local_tab) and copies it to the
// chip every batch. Here the card builds it from what is already there: the
// node sets and the global neighbor table. For subgraph b and member row s
// (node g = nodes[b, s]) the row lists, in the order of nbr[g, 0:deg[g]],
// the local slot of every neighbor that is a member of the same subgraph,
// with the target link removed from rows 0 and 1 (reference utils.py:78-80):
//     loc[b, s, 0:n)  = those slots (n, the row's local degree)
//     loc[b, s, n:W)  = -1
// The table carries no weights: an entry's weight is 1 where its slot is
// >= 0 and 0 elsewhere, and pos_power_rows takes it so (w = null). The
// caller's W, a multiple of 4, is one no row's local degree passes
// (ops/local_table.py). Rows of empty slots are all -1. Keeping the global
// table's order keeps the order in which the global-id route's selector
// meets the same entries, so pos_power_rows adds them in the same order and
// gives the same bits.
//
// What bounds it on an H100: bytes. It reads the node sets and the member
// rows' live entries of the global table, and writes the table, 4 bytes an
// entry of width W. At the hub batch (B = 64, S = 1,024, W = 1,024) the
// writes are 268 MB of its 322 MB.
//
// Design: the grid is (block of rows_per_block rows, subgraph), the rows a
// block chosen by the wrapper (ops/local_table.rows_per_block). Each block
// hashes its subgraph's member ids into an open-addressing table id -> slot
// in shared memory, one 8-byte cell (id, slot) a probe, at most a quarter
// full (T >= 4S cells, 32 KB at S = 1,024; half full where that passes
// kHashBudget): on the hub batch a half-full table's probe chains, the
// longest lane's setting each warp's pace, took more time than all the
// stores. Beside it the block lays its rows' live prefixes end to end: row
// r's entries are the stream's [off[r], off[r+1]). A row's length is its
// node's degree (thousands at a hub, a dozen elsewhere), so a warp a row
// would wait on one dependent read after another down a hub's row while a
// short row leaves most lanes idle. Instead the block walks the stream in
// tiles of kTile entries, kPerThread consecutive entries a thread, all loads
// of a tile in flight at once (4 a thread: with 8 or 16 a short block's
// threads walked longer chains of lookups one after another, with 1 or 2 a
// hub's block took more tiles; both ran slower). Each entry is looked up in
// the hash, the first probes of a thread's entries issued together. A
// block-wide scan of the threads' hit counts gives every hit its rank in the
// stream, and its column is that rank less the rank of its row's first
// entry, so each row's hits land compacted in order with no atomics: every
// run writes the same table. Then a warp a row writes the padding, -1 with
// one 16-byte store a lane from the first multiple of 4 past the row's hits.
// One launch builds a batch's table: W is the width no row can pass, so no
// count has to reach the host first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                 // consecutive stream entries a thread
constexpr int kTile = kThreads * kPerThread;  // stream entries a block reads at once
constexpr int kMaxRows = kThreads;            // rows a block may take
constexpr int kHashBudget = 96 * 1024;        // bytes of hash kept a quarter full
constexpr unsigned kFull = 0xffffffffu;

// log2 of the hash table's cells: the least power of two >= 4S, or >= 2S
// where 4S cells of 8 bytes would pass kHashBudget.
int hash_log(int S) {
  int l = 1;
  while ((1 << l) < 4 * S) ++l;
  if ((int64_t{8} << l) > kHashBudget) --l;
  return l;
}

__device__ __forceinline__ int hash_of(int id, int log_t) {
  return static_cast<int>((static_cast<unsigned>(id) * 2654435761u) >> (32 - log_t));
}

// Exclusive prefix of v over the block's threads, and the block's total
// (`sums`: kWarps ints of shared memory). Every thread must call it; it
// ends with a barrier, so `sums` may be used again at once.
__device__ __forceinline__ int block_scan(int v, int* sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = sums[w];
    before += w < warp ? x : 0;
    total += x;
  }
  __syncthreads();
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads)
local_table_kernel(const int* __restrict__ nbr,                // [N, D_tab] global ids
                   const int* __restrict__ deg,                // [N] live prefix of each row
                   int64_t D_tab,
                   const int* __restrict__ nodes,              // [B, S] global ids
                   const unsigned char* __restrict__ node_mask,  // [B, S] member slots
                   const int* __restrict__ links,              // [B, 2] (src, dst)
                   int S, int W, int log_t, int rows_per_block,
                   int* __restrict__ loc) {                    // [B, S, W]
  extern __shared__ int2 cells[];  // [T] (member id, its slot); id -1 empty
  const int T = 1 << log_t;
  int* row_g = reinterpret_cast<int*>(cells + T);  // [kMaxRows] each row's node
  int* row_off = row_g + kMaxRows;         // [kMaxRows + 1] each row's first stream entry
  int* row_rank = row_off + kMaxRows + 1;  // [kMaxRows + 1] the hits before each row
  int* sums = row_rank + kMaxRows + 1;     // [kWarps] block_scan's
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int s_first = blockIdx.x * rows_per_block;
  const int R = min(rows_per_block, S - s_first);  // this block's rows
  const int* nodes_b = nodes + static_cast<int64_t>(b) * S;
  const unsigned char* mask_b = node_mask + static_cast<int64_t>(b) * S;

  for (int i = tid; i < T; i += kThreads) cells[i] = make_int2(-1, -1);
  // Each node id is read with its mask bit, not after it: the build waits on
  // one read of the node sets, then one of the rows' degrees.
  int live = 0;  // the live entries of row tid (none on an empty slot)
  if (tid < R) {
    const int g = nodes_b[s_first + tid];
    const bool member = mask_b[s_first + tid];
    row_g[tid] = member ? g : 0;
    live = member ? deg[g] : 0;
  }
  __syncthreads();
  // Member ids are unique; where one repeats, its last slot wins (as in the
  // host table build), whatever order the threads insert in.
  for (int j = tid; j < S; j += kThreads) {
    const int id = nodes_b[j];
    if (!mask_b[j]) continue;
    for (int p = hash_of(id, log_t);; p = (p + 1) & (T - 1)) {
      const int prev = atomicCAS(&cells[p].x, -1, id);
      if (prev == -1 || prev == id) {
        atomicMax(&cells[p].y, j);
        break;
      }
    }
  }
  int total;  // the stream's entries
  const int off = block_scan(live, sums, total);
  if (tid < R) row_off[tid] = off;
  if (tid == 0) row_off[R] = total;
  __syncthreads();  // the hash and the row offsets are complete

  const int src = links[2 * static_cast<int64_t>(b)];
  const int dst = links[2 * static_cast<int64_t>(b) + 1];
  int* loc_b = loc + static_cast<int64_t>(b) * S * W;
  int ranked = 0;  // the hits in the tiles before this one
  for (int t0 = 0; t0 < total; t0 += kTile) {  // the same in every thread
    const int e0 = t0 + tid * kPerThread;
    // The row of entry e0: the r with row_off[r] <= e0 < row_off[r + 1].
    int r = 0;
    if (e0 < total) {
      int hi = R;
      while (hi - r > 1) {
        const int mid = (r + hi) >> 1;
        if (row_off[mid] <= e0) r = mid; else hi = mid;
      }
    }
    int rows[kPerThread], slot[kPerThread];
    // Every load of the tile is issued before any is used.
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = e0 + i;
      rows[i] = -1;
      slot[i] = -1;  // the neighbor's id, until it is looked up
      if (e < total) {
        while (row_off[r + 1] <= e) ++r;
        rows[i] = r;
        slot[i] = nbr[static_cast<int64_t>(row_g[r]) * D_tab + (e - row_off[r])];
      }
    }
    // Look each id up: every first probe first, then the chains.
    int pos[kPerThread];
    int2 cell[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int id = slot[i];
      // The target link's entry leaves rows 0 (src) and 1 (dst).
      const int s = s_first + rows[i];
      const bool drop = (s == 0 && id == dst) || (s == 1 && id == src);
      if (rows[i] < 0 || id < 0 || drop) slot[i] = -1;
      pos[i] = hash_of(slot[i], log_t);
      cell[i] = slot[i] >= 0 ? cells[pos[i]] : make_int2(-1, -1);
    }
    int hits = 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int id = slot[i];
      if (id >= 0) {
        while (cell[i].x != id && cell[i].x != -1) {
          pos[i] = (pos[i] + 1) & (T - 1);
          cell[i] = cells[pos[i]];
        }
      }
      slot[i] = id >= 0 && cell[i].x == id ? cell[i].y : -1;
      hits += slot[i] >= 0;
    }
    int tile_hits;
    int rank = ranked + block_scan(hits, sums, tile_hits);
    // The hits before each row that starts in this thread's entries, and
    // before the empty rows just ahead of it, which start there too.
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = e0 + i;
      if (rows[i] >= 0 && row_off[rows[i]] == e)
        for (int q = rows[i]; q >= 0 && row_off[q] == e; --q) row_rank[q] = rank;
      rank += slot[i] >= 0;
    }
    __syncthreads();
    rank -= hits;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (slot[i] < 0) continue;
      const int col = rank - row_rank[rows[i]];
      if (col < W) loc_b[static_cast<int64_t>(s_first + rows[i]) * W + col] = slot[i];
      ++rank;
    }
    ranked += tile_hits;
  }
  // The rows that start at the stream's end (the empty rows at the back,
  // and the end itself) have every hit before them.
  for (int q = tid; q <= R; q += kThreads)
    if (row_off[q] == total) row_rank[q] = ranked;
  __syncthreads();

  // Padding: a warp a row, -1 from the row's local degree n to W; 4-byte
  // stores up to the first multiple of 4, then 16-byte ones.
  const int lane = tid & 31;
  const int4 pad = make_int4(-1, -1, -1, -1);
  for (int q = tid >> 5; q < R; q += kWarps) {
    int* out = loc_b + static_cast<int64_t>(s_first + q) * W;
    const int n = min(row_rank[q + 1] - row_rank[q], W);
    const int n4 = (n + 3) & ~3;
    if (n + lane < n4) out[n + lane] = -1;
    for (int i = n4 + 4 * lane; i < W; i += 4 * 32) *reinterpret_cast<int4*>(out + i) = pad;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes: the hash table's cells,
// the rows' nodes, offsets and ranks, and the scan's sums.
int64_t s3grl_local_table_smem(int S) {
  return (int64_t{8} << hash_log(S)) + int64_t{4} * (3 * kMaxRows + 2 + kWarps);
}

// One launch on `stream` that writes the table at width W (a multiple of
// 4; loc 16-byte aligned), each block taking rows_per_block (1 to 256) rows
// of one subgraph. Returns the cudaError_t of the launch (0 = success).
int s3grl_local_table(const int* nbr, const int* deg, int64_t D_tab, const int* nodes,
                      const unsigned char* node_mask, const int* links, int B, int S,
                      int W, int rows_per_block, int* loc, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (B > 65535 || rows_per_block < 1 || rows_per_block > kMaxRows || W % 4 != 0 ||
      reinterpret_cast<uintptr_t>(loc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int log_t = hash_log(S);
  const int64_t smem = s3grl_local_table_smem(S);
  cudaError_t err = cudaFuncSetAttribute(
      local_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + rows_per_block - 1) / rows_per_block, B);
  local_table_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nbr, deg, D_tab, nodes, node_mask, links, S, W, log_t, rows_per_block, loc);
  return static_cast<int>(cudaGetLastError());
}

const char* s3grl_local_table_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
