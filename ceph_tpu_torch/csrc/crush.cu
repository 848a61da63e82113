// Bulk CRUSH placement for Hopper (sm_90a): kernel K5 ``crush_map_rule``.
//
// It replaces the two XLA programs of ceph_tpu/crush/vectorized.py,
// VectorCrush.map_firstn (:384) and VectorCrush.map_indep (:449), with their
// helpers hash32_2_jnp / hash32_3_jnp / crush_ln_jnp / straw2_draws /
// is_out_jnp (:60-160): one CRUSH rule (chooseleaf or choose, firstn or
// indep, jewel tunables) over a uniform-depth straw2 hierarchy for L seeds
// -> (L, numrep) OSDs with CRUSH_ITEM_NONE holes, decision for decision with
// mapper.c (ceph_tpu/crush/mapper.py).
//
// Bound on the H100: integer issue, not bytes.  A straw2 draw is one
// hash32_3 (5 rjenkins mixes, ~140 32-bit integer operations), crush_ln (two
// table lookups and a 64-bit product) and a 64-bit division.  At BASELINE.md
// config 5 (a 1000-OSD map of fanouts 5/5/4/10, 3 replicas) a lane makes at
// least 3 x 24 draws, so 10M lanes are >= 1.0e11 operations: ~6 ms at 64
// INT32 lanes a clock a SM, 132 SMs, 1.98 GHz, against ~0.05 ms for the bytes
// (4 in and 4 * numrep out a lane).  The 64-bit division (a software routine
// of tens of instructions) is what this first design spends most on.
//
// The design:
//   - One thread per lane, walking the lanes grid-stride.  Each thread runs
//     the scalar engine's retry loops for its own lane.  The reference's
//     lockstep loops share their counters across lanes, but a lane that is
//     done freezes and (indep) only slots still UNDEF change, so per lane the
//     decisions are the same.  Lanes of a warp diverge on retries; accepted.
//   - The map arrives as one int32 buffer (the wrapper's kernel_map_words): a
//     header, per level {N, offsets of child ids (B, N), child rows (B, N)
//     and weights (P, B, N), B}, then the tables; the depth and the number of
//     choose_args positions P are runtime values.  A block stages it in
//     shared memory when it fits (a 1000-OSD map is ~14 KB), else reads it
//     from global memory.  The crush_ln tables (514 int64) are always staged:
//     lanes index them divergently, which constant memory would serialise.
//   - A lane's placed OSDs live in its output row, the selections it
//     collides on (firstn's buckets, indep's slots) in a scratch row of the
//     same shape, so numrep has no cap.  firstn writes each placement at its
//     placed count, which is the reference's stable compaction of NONE holes.
//   - Bit-exact points: the hash takes the uint32 bit patterns of x and of
//     negative ids; crush_ln's 17-bit normalisation and (x * rh) >> 48 as an
//     unsigned 64-bit product; (ln - 2^48) / w truncating toward zero, S64_MIN
//     for w <= 0; the first largest draw wins (strict >, padded columns
//     weigh 0); choose_args positions clipped to P - 1 (firstn: the placed
//     count for descent and leaf; indep: 0 for descent, the slot for the
//     leaf); firstn r = rep + ftotal and leaf r + ft, indep r = rep + numrep
//     * ftotal and leaf rep + r + numrep * ft.
//
// Plain C interface for ctypes: crush_config sizes the grid once per device
// and map size; the entry launches on the given device and stream,
// allocates nothing, and returns cudaGetLastError() (0 = launched).
//
// Without __CUDACC__ the kernel also compiles as host C++ (no launcher, no C
// entry): the includer supplies the CUDA built-ins it uses (threadIdx,
// blockIdx, blockDim, gridDim, __syncthreads, __clz, the dynamic shared
// memory) and runs each block's threads itself.  A CPU test builds it that
// way.

#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kLnWords = 258 + 256;          // RH_LH then LL, int64
constexpr int kHeaderWords = 8;
constexpr int kLevelWords = 5;
// the largest map a block stages in shared memory, in int32 words
constexpr int kMaxStagedWords = 40 * 1024;
constexpr int kNone = 0x7FFFFFFF;
constexpr int kUndef = 0x7FFFFFFE;
constexpr long long kS64Min = -0x7FFFFFFFFFFFFFFFLL - 1;

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

constexpr uint32_t kHashSeed = 1315423911u;

__device__ __forceinline__ uint32_t hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b, x = 231232, y = 1232;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c, x = 231232, y = 1232;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// 2^44 * log2(u + 1), u in [0, 0xffff] (mapper.c crush_ln)
__device__ __forceinline__ long long crush_ln(uint32_t u, const long long* ln) {
  uint32_t x = u + 1;
  long long iexpon = 15;
  if (!(x & 0x18000)) {
    const int bits = __clz(static_cast<int>(x & 0x1FFFF)) - 16;
    x <<= bits;
    iexpon = 15 - bits;
  }
  const int index1 = static_cast<int>((x >> 8) << 1);
  const long long rh = ln[index1 - 256];
  const long long lh = ln[index1 + 1 - 256];
  const unsigned long long xl64 =
      (static_cast<unsigned long long>(x) * static_cast<unsigned long long>(rh)) >> 48;
  return (iexpon << 44) + ((lh + ln[258 + (xl64 & 0xFF)]) >> 4);
}

struct Level {
  int n, ids, idx, w, b;
};

__device__ __forceinline__ Level level(const int* m, int l) {
  const int* d = m + kHeaderWords + kLevelWords * l;
  return {d[0], d[1], d[2], d[3], d[4]};
}

// the column of the first largest straw2 draw of bucket row `row` at `lv`,
// weight-set position p
__device__ __forceinline__ int straw2(const int* m, const Level& lv, int row, int p, uint32_t x,
                                      uint32_t r, const long long* ln) {
  const int* ids = m + lv.ids + row * lv.n;
  const int* w = m + lv.w + (p * lv.b + row) * lv.n;
  long long best = kS64Min;
  int pick = 0;
  for (int j = 0; j < lv.n; ++j) {
    const int wj = w[j];
    long long draw = kS64Min;
    if (wj > 0) {
      const uint32_t u = hash32_3(x, static_cast<uint32_t>(ids[j]), r) & 0xFFFF;
      draw = (crush_ln(u, ln) - 0x1000000000000LL) / wj;
    }
    if (j == 0 || draw > best) {
      best = draw;
      pick = j;
    }
  }
  return pick;
}

// rows into level `upto`'s tables (osd ids when upto is the last level + 1)
__device__ __forceinline__ int descend(const int* m, int upto, int p, uint32_t x, uint32_t r,
                                       const long long* ln) {
  int cur = 0;
  for (int l = 0; l < upto; ++l) {
    const Level lv = level(m, l);
    cur = m[lv.idx + cur * lv.n + straw2(m, lv, cur, p, x, r, ln)];
  }
  return cur;
}

__device__ __forceinline__ bool is_out(const int* osd_w, int osd, uint32_t x) {
  const int w = osd_w[osd];
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return static_cast<int>(hash32_2(x, static_cast<uint32_t>(osd)) & 0xFFFF) >= w;
}

__device__ __forceinline__ bool taken(const int* row, int n, int v) {
  for (int k = 0; k < n; ++k)
    if (row[k] == v) return true;
  return false;
}

__device__ void map_firstn(const int* m, uint32_t x, int numrep, const int* osd_w,
                           const long long* ln, int* out, int* sel) {
  const int levels = m[1], positions = m[2], leaf = m[4], tries = m[5], leaf_tries = m[6];
  const Level last = level(m, m[0] - 1);
  int placed = 0;
  for (int rep = 0; rep < numrep; ++rep) {
    const int p = placed < positions - 1 ? placed : positions - 1;
    for (int ftotal = 0; ftotal < tries; ++ftotal) {
      const uint32_t r = static_cast<uint32_t>(rep + ftotal);
      const int cur = descend(m, levels, p, x, r, ln);
      if (taken(sel, placed, cur)) continue;
      int osd = kNone;
      if (leaf) {
        for (int ft = 0; ft < leaf_tries; ++ft) {
          const int cand =
              m[last.idx + cur * last.n + straw2(m, last, cur, p, x, r + ft, ln)];
          if (!is_out(osd_w, cand, x) && !taken(out, placed, cand)) {
            osd = cand;
            break;
          }
        }
        if (osd == kNone) continue;
      } else {
        if (is_out(osd_w, cur, x) || taken(out, placed, cur)) continue;
        osd = cur;
      }
      out[placed] = osd;
      sel[placed] = cur;
      ++placed;
      break;
    }
  }
  for (int k = placed; k < numrep; ++k) out[k] = kNone;
}

__device__ void map_indep(const int* m, uint32_t x, int numrep, const int* osd_w,
                          const long long* ln, int* out, int* sel) {
  const int levels = m[1], positions = m[2], leaf = m[4], tries = m[5], leaf_tries = m[6];
  const Level last = level(m, m[0] - 1);
  for (int k = 0; k < numrep; ++k) out[k] = sel[k] = kUndef;
  int left = numrep;
  for (int ftotal = 0; ftotal < tries && left > 0; ++ftotal) {
    for (int rep = 0; rep < numrep; ++rep) {
      if (sel[rep] != kUndef) continue;
      const uint32_t r = static_cast<uint32_t>(rep + numrep * ftotal);
      const int cur = descend(m, levels, 0, x, r, ln);
      if (taken(sel, numrep, cur)) continue;
      int osd = kNone;
      if (leaf) {
        const int p = rep < positions - 1 ? rep : positions - 1;
        for (int ft = 0; ft < leaf_tries; ++ft) {
          const uint32_t r_leaf = static_cast<uint32_t>(rep) + r + static_cast<uint32_t>(numrep * ft);
          const int cand = m[last.idx + cur * last.n + straw2(m, last, cur, p, x, r_leaf, ln)];
          if (!is_out(osd_w, cand, x)) {
            osd = cand;
            break;
          }
        }
        if (osd == kNone) continue;
      } else {
        if (is_out(osd_w, cur, x)) continue;
        osd = cur;
      }
      out[rep] = osd;
      sel[rep] = cur;
      --left;
    }
  }
  for (int k = 0; k < numrep; ++k)
    if (out[k] == kUndef) out[k] = kNone;
}

// xs (n,) seeds; map: kernel_map_words (map_words int32, staged in shared
// memory if `staged`); ln: RH_LH then LL; out, sel: (n, numrep)
__global__ void __launch_bounds__(kThreads)
    crush_map_rule_kernel(const int* xs, long long n, int numrep, const int* osd_w,
                          const int* map, int map_words, int staged, const long long* ln_g,
                          int* out, int* sel) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* ln = reinterpret_cast<long long*>(smem);
  int* staged_map = reinterpret_cast<int*>(smem + kLnWords * sizeof(long long));
  for (int i = threadIdx.x; i < kLnWords; i += blockDim.x) ln[i] = ln_g[i];
  if (staged)
    for (int i = threadIdx.x; i < map_words; i += blockDim.x) staged_map[i] = map[i];
  __syncthreads();
  const int* m = staged ? staged_map : map;
  const bool firstn = m[3] != 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; lane < n;
       lane += stride) {
    const uint32_t x = static_cast<uint32_t>(xs[lane]);
    int* o = out + lane * numrep;
    int* s = sel + lane * numrep;
    if (firstn)
      map_firstn(m, x, numrep, osd_w, ln, o, s);
    else
      map_indep(m, x, numrep, osd_w, ln, o, s);
  }
}

inline bool stages(int map_words) { return map_words <= kMaxStagedWords; }

inline size_t smem_bytes(int map_words) {
  return kLnWords * sizeof(long long) +
         (stages(map_words) ? static_cast<size_t>(map_words) * sizeof(int) : 0);
}

}  // namespace

#ifdef __CUDACC__

extern "C" {

// xs (n,) int32 seeds; osd_w int32 weights covering every OSD of the map;
// map (map_words,) int32 as kernel_map_words lays it out; ln (514,) int64;
// out and sel (n, numrep) int32, sel scratch.  All on `device`.
// max_blocks: crush_config's info[4] for this device and map_words (the
// blocks resident on the whole card), which the caller computes once.
int crush_map_rule(const void* xs, long long n, int numrep, const void* osd_w, const void* map,
                   int map_words, const void* ln, void* out, void* sel, int max_blocks,
                   int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (n < 1 || numrep < 1 || map_words < kHeaderWords || max_blocks < 1 || xs == nullptr ||
      osd_w == nullptr || map == nullptr || ln == nullptr || out == nullptr || sel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < max_blocks ? want : max_blocks);
  crush_map_rule_kernel<<<blocks, kThreads, smem_bytes(map_words),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(xs), n, numrep, static_cast<const int*>(osd_w),
      static_cast<const int*>(map), map_words, stages(map_words) ? 1 : 0,
      static_cast<const long long*>(ln), static_cast<int*>(out), static_cast<int*>(sel));
  return static_cast<int>(cudaGetLastError());
}

// Opens the kernel's shared memory to the largest map it stages, on
// `device`, and gives info = {registers a thread, dynamic shared memory
// bytes a block, resident blocks a SM, local memory bytes a thread, resident
// blocks on the card} for a map of map_words.  Call it once per device and
// map size before crush_map_rule.
int crush_config(int device, int map_words, int* info) {
  const size_t smem = smem_bytes(map_words);
  int sms = 0, blocks = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(crush_map_rule_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(kMaxStagedWords)));
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, crush_map_rule_kernel, kThreads,
                                                      smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, crush_map_rule_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(smem);
  info[2] = blocks;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = sms * blocks;
  return 0;
}

}  // extern "C"

#endif  // __CUDACC__
