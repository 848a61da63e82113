// Bulk CRUSH placement for Hopper (sm_90a): kernel K5 ``crush_map_rule``.
//
// It replaces the two XLA programs of ceph_tpu/crush/vectorized.py,
// VectorCrush.map_firstn (:384) and VectorCrush.map_indep (:449), with their
// helpers hash32_2_jnp / hash32_3_jnp / crush_ln_jnp / straw2_draws /
// is_out_jnp (:60-160): one CRUSH rule (chooseleaf or choose, firstn or
// indep, jewel tunables with any chooseleaf_vary_r) over a uniform-depth
// hierarchy drawn as straw2 (straw2 buckets, and straw buckets without
// legacy straw values, which the scalar engine draws as straw2) for L seeds
// -> (L, numrep) OSDs with CRUSH_ITEM_NONE holes, decision for decision with
// mapper.c (ceph_tpu/crush/mapper.py).
//
// Bound on the H100: integer issue, not bytes.  A straw2 draw is one
// hash32_3 (5 rjenkins mixes, ~140 32-bit integer operations), crush_ln (two
// table lookups and a product) and a division by the item's weight.  Of
// those operations the mixes' 45 XORs and 30 right shifts have only the ALU
// pipe (64 lanes a clock a SM); the rest can go to the FMA pipe as IMADs,
// and a SM issues at most 128 lanes a clock in all: a draw takes at least
// max(75 / 64, 140 / 128) clocks a SM per lane.  At BASELINE.md config 5 (a
// 1000-OSD map of fanouts 5/5/4/10, 3 replicas) a lane makes at least 3 x 24
// draws, so 10M lanes take >= 3.2 ms at 132 SMs and 1.98 GHz, against
// ~0.05 ms for the bytes (4 in and 4 * numrep out a lane).  Compiled, a
// draw is ~231 SASS instructions: ~117 on the integer ALU pipe (LOP3, SHF,
// IADD3, ISETP, SEL, LEA) and ~101 IMADs on the FMA pipe, each pipe 16
// lanes a clock a scheduler, all of them through one issue slot a clock.
//
// The design:
//   - No division in a draw.  The draw is trunc((crush_ln(u) - 2^48) / w),
//     and crush_ln(u) < 2^48 for every 16-bit u, so it is -(n / w) for
//     n = 2^48 - crush_ln(u) in [1, 2^48].  The wrapper stores, beside each
//     weight w > 0, a multiplier m = ceil(2^(49+b) / w) with 2^b >= w
//     (straw2_magic in crush/vectorized.py), and n / w = (n * m) >> (49 + b)
//     exactly for every n < 2^49 (Granlund-Montgomery): one 64-bit high
//     product (IMAD.WIDEs) and a shift instead of a called division routine
//     of ~83 instructions.  A weight <= 0 stores 0: its draw is S64_MIN.  A
//     row's pick is the first child of the least quotient (the first largest
//     draw), a weight <= 0 the largest key.  crush_ln reads bits 48..55 of
//     x * rh from 32-bit halves.
//   - One thread per lane, and one descent per pass of one loop a thread.
//     A pass takes the thread's next step: firstn its (rep, ftotal), indep
//     its next unfilled (ftotal, slot) in the reference's order (the slots
//     of a round in order, skipping those filled, then the next round); a
//     thread whose lane is done takes its next lane (grid-stride) at the top
//     of the pass.  So the lanes of a warp descend together, and a warp's
//     passes are its slowest thread's steps over all its lanes, not every
//     slot of every round of every lane.  The reference's lockstep loops
//     share their counters across lanes, but a lane that is done freezes and
//     (indep) only slots still UNDEF change, so per lane the decisions are
//     the same.
//   - The warp must reconverge every pass, and only structured control flow
//     gives ptxas a point to do it: the lane change has no exit inside it,
//     and the scans of a lane's row (taken(), indep's next slot) read every
//     entry instead of stopping at a match.  A lane change with a return in
//     it, or scans that stop early, let ptxas split a warp for good: 4x and
//     2x slower at config 5.
//   - The map arrives as one int32 buffer (the wrapper's kernel_map_words): a
//     header, per level {N, offsets of child ids (B, N), child rows (B, N)
//     and multipliers (P, B, N) int64, B}, then the tables; the depth and the
//     number of choose_args positions P are runtime values.  A block stages
//     it in shared memory when it is small (a 1000-OSD map is ~18 KB), else
//     reads it from global memory; the kernel body is instantiated for each, so
//     the staged map is read with shared-memory loads.  The crush_ln tables
//     (514 int64) are always staged: lanes index them divergently, which
//     constant memory would serialise.
//   - A lane's placed OSDs live in its output row, the selections it
//     collides on (firstn's buckets, indep's slots) in a scratch row of the
//     same shape, so numrep has no cap.  firstn's rows start kNone and each
//     placement goes to its placed count, which is the reference's stable
//     compaction of NONE holes.
//   - Bit-exact points: the hash takes the uint32 bit patterns of x and of
//     negative ids; crush_ln's 17-bit normalisation and bits 48..55 of the
//     unsigned 64-bit product x * rh; the exact quotient, S64_MIN for w <= 0;
//     the first largest draw wins (strict >, padded columns weigh 0);
//     choose_args positions clipped to P - 1 (firstn: the placed count for
//     descent and leaf; indep: 0 for descent, the slot for the leaf); firstn
//     r = rep + ftotal and leaf sub_r + ft with sub_r = r >> (vary_r - 1),
//     0 for vary_r 0 (the header's leaf word is 1 + that shift, 32 for
//     vary_r 0), indep r = rep + numrep * ftotal and leaf
//     rep + r + numrep * ft.
//
// Plain C interface for ctypes: crush_config sizes the grid once per device
// and map size; the entry launches on the given device and stream,
// allocates nothing, and returns cudaGetLastError() (0 = launched).
//
// Without __CUDACC__ the kernel also compiles as host C++ (no launcher, no C
// entry): the includer supplies the CUDA built-ins it uses (threadIdx,
// blockIdx, blockDim, gridDim, __syncthreads, __clz, __umulhi, __umul64hi,
// the dynamic shared memory) and runs each block's threads itself.  A CPU
// test builds it that way.

#include <cstddef>
#include <cstdint>
#include <cstring>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kLnWords = 258 + 256;          // RH_LH then LL, int64
constexpr int kHeaderWords = 8;
constexpr int kLevelWords = 5;
// the largest map a block stages in shared memory, in int32 words: 36 KB a
// block with the crush_ln tables, so staging never costs the resident
// blocks the registers allow (5 a SM).  At 4 words a child (id, row, int64
// multiplier) and one weight-set position that is ~2,000 items; a larger
// map is read from global memory, which beats staging it at fewer blocks
// (measured on an H100: a 9,000-OSD map of 40,068 words, 1.4x slower staged
// at 1 block a SM)
constexpr int kMaxStagedWords = 8 * 1024;
constexpr int kNone = 0x7FFFFFFF;
constexpr int kUndef = 0x7FFFFFFE;
// a multiplier's low 56 bits; its shift b sits above them
constexpr unsigned long long kMagicMask = (1ull << 56) - 1;

// Lines of each mix whose two subtractions run as two IMADs on the FMA pipe
// instead of one IADD3 on the integer ALU pipe.  The hash alone would put
// 120 of a draw's ~152 ALU-pipe instructions there (45 IADD3, 45 LOP3, 30
// SHF; the left shifts are IMADs already); 7 of 9 lines moves 35 IADD3s
// off it for 35 more instructions in all (measured on an H100: 7 beat 5,
// 6 and 9, and 0 by ~8%).
constexpr int kFmaSubs = 7;

#ifdef __CUDACC__
// -1 where no compiler can see it, so that x * kMinusOne stays a multiply
__constant__ uint32_t kMinusOne = 0xFFFFFFFFu;
#else
constexpr uint32_t kMinusOne = 0xFFFFFFFFu;
#endif

// a - b - c, on the FMA pipe for the first kFmaSubs lines of a mix
template <int kLine>
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b, uint32_t c) {
  if (kLine < kFmaSubs) return a + b * kMinusOne + c * kMinusOne;
  return a - b - c;
}

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a = sub2<0>(a, b, c) ^ (c >> 13);
  b = sub2<1>(b, c, a) ^ (a << 8);
  c = sub2<2>(c, a, b) ^ (b >> 13);
  a = sub2<3>(a, b, c) ^ (c >> 12);
  b = sub2<4>(b, c, a) ^ (a << 16);
  c = sub2<5>(c, a, b) ^ (b >> 5);
  a = sub2<6>(a, b, c) ^ (c >> 3);
  b = sub2<7>(b, c, a) ^ (a << 10);
  c = sub2<8>(c, a, b) ^ (b >> 15);
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

// one RH_LH pair: 2^48 / (1 + k/128) and 2^48 * log2(1 + k/128)
struct alignas(16) RhLh {
  long long rh, lh;
};

// 2^48 - crush_ln(u), u in [0, 0xffff]: in [1, 2^48] (mapper.c crush_ln is
// 2^44 * log2(u + 1), below 2^48)
__device__ __forceinline__ unsigned long long ln_gap(uint32_t u, const long long* ln) {
  uint32_t x = u + 1;                          // <= 0x10000
  int bits = __clz(static_cast<int>(x)) - 16;  // normalise below 0x8000
  bits = bits > 0 ? bits : 0;
  x <<= bits;
  const RhLh t = reinterpret_cast<const RhLh*>(ln)[(x >> 8) - 128];
  // bits 48..55 of the unsigned product x * rh are bits 16..23 of
  // x * hi(rh) + hi(x * lo(rh)), mod 2^32
  const uint32_t mid = __umulhi(x, static_cast<uint32_t>(t.rh)) +
                       x * static_cast<uint32_t>(static_cast<unsigned long long>(t.rh) >> 32);
  const long long lnv = (static_cast<long long>(15 - bits) << 44) +
                        ((t.lh + ln[258 + ((mid >> 16) & 0xFF)]) >> 4);
  return (1ull << 48) - static_cast<unsigned long long>(lnv);
}

// n / w for n in [0, 2^49), `magic` the multiplier straw2_magic built for w
__device__ __forceinline__ unsigned long long straw2_quotient(unsigned long long n,
                                                              unsigned long long magic) {
  return __umul64hi(n << 15, magic & kMagicMask) >> static_cast<int>(magic >> 56);
}

// a child's straw2 key: the quotient n / w, whose negation is its draw, so
// the least key is the largest draw; ~0 (below every draw, S64_MIN) for a
// weight <= 0
__device__ __forceinline__ unsigned long long straw2_key(uint32_t x, int id, uint32_t r,
                                                         unsigned long long magic,
                                                         const long long* ln) {
  if (magic == 0) return ~0ull;
  const uint32_t u = hash32_3(x, static_cast<uint32_t>(id), r) & 0xFFFF;
  return straw2_quotient(ln_gap(u, ln), magic);
}

__device__ __forceinline__ unsigned long long load_u64(const int* p) {
#ifdef __CUDACC__
  return *reinterpret_cast<const unsigned long long*>(p);
#else
  unsigned long long v;
  std::memcpy(&v, p, sizeof v);
  return v;
#endif
}

struct Level {
  int n, ids, idx, magic, b;
};

__device__ __forceinline__ Level level(const int* m, int l) {
  const int* d = m + kHeaderWords + kLevelWords * l;
  return {d[0], d[1], d[2], d[3], d[4]};
}

// the column of the first largest straw2 draw (least key) of bucket row
// `row` at `lv`, weight-set position p
__device__ __forceinline__ int straw2(const int* m, const Level& lv, int row, int p, uint32_t x,
                                      uint32_t r, const long long* ln) {
  const int* ids = m + lv.ids + row * lv.n;
  const int* magic = m + lv.magic + 2 * ((p * lv.b + row) * lv.n);
  unsigned long long best = ~0ull;
  int pick = 0;
  for (int j = 0; j < lv.n; ++j) {
    const unsigned long long key = straw2_key(x, ids[j], r, load_u64(magic + 2 * j), ln);
    if (key < best) {
      best = key;
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

// whether v is in row[0, n): every entry read, so that a warp's threads
// run the same iterations
__device__ __forceinline__ bool taken(const int* row, int n, int v) {
  bool hit = false;
  for (int k = 0; k < n; ++k) hit |= row[k] == v;
  return hit;
}

// What a rule reads from the map's header, and a lane's state.
struct Rule {
  const int* m;
  const int* osd_w;
  const long long* ln;
  int numrep, levels, positions, leaf, tries, leaf_tries;
  Level last;
  uint32_t x;
  int* o;                       // the lane's output row
  int* s;                       // its selections
  int rep, ftotal, placed;      // placed: firstn's count; indep's slots left

  __device__ __forceinline__ Rule(const int* m_, const int* osd_w_, const long long* ln_,
                                  int numrep_)
      : m(m_), osd_w(osd_w_), ln(ln_), numrep(numrep_), levels(m_[1]), positions(m_[2]),
        leaf(m_[4]), tries(m_[5]), leaf_tries(m_[6]), last(level(m_, m_[0] - 1)), x(0),
        o(nullptr), s(nullptr), rep(0), ftotal(0), placed(0) {}

  __device__ __forceinline__ void lane(uint32_t x_, int* o_, int* s_, int fill) {
    x = x_;
    o = o_;
    s = s_;
    for (int k = 0; k < numrep; ++k) o[k] = s[k] = fill;
    rep = ftotal = 0;
  }

  // the OSD that the leaf draw picks in last-level bucket row `cur`,
  // weight-set position p, for r
  __device__ __forceinline__ int leaf_of(int cur, int p, uint32_t r) const {
    return m[last.idx + cur * last.n + straw2(m, last, cur, p, x, r, ln)];
  }
};

// firstn: a pass is the lane's (rep, ftotal) step; a lane's row starts
// kNone and each placement goes to its placed count, which is the
// reference's stable compaction of NONE holes
struct Firstn : Rule {
  using Rule::Rule;

  __device__ __forceinline__ void start(uint32_t x_, int* o_, int* s_) {
    lane(x_, o_, s_, kNone);
    placed = 0;
  }
  __device__ __forceinline__ bool done() const { return rep >= numrep; }
  __device__ __forceinline__ void finish() const {}

  __device__ __forceinline__ void pass() {
    const int p = placed < positions - 1 ? placed : positions - 1;
    const uint32_t r = static_cast<uint32_t>(rep + ftotal);
    const int cur = descend(m, levels, p, x, r, ln);
    int osd = kNone;
    if (!taken(s, numrep, cur)) {
      if (leaf) {
        // the header's leaf word is 1 + the shift of sub_r (32: sub_r 0),
        // read from `leaf` here: the shift as a member of its own costs the
        // kernel 16 bytes of stack and 12 spill stores (ptxas, sm_90a)
        const int shift = leaf - 1;
        const uint32_t sub_r = shift < 32 ? r >> shift : 0u;
        for (int ft = 0; ft < leaf_tries; ++ft) {
          const int cand = leaf_of(cur, p, sub_r + ft);
          if (!is_out(osd_w, cand, x) && !taken(o, numrep, cand)) {
            osd = cand;
            break;
          }
        }
      } else if (!is_out(osd_w, cur, x) && !taken(o, numrep, cur)) {
        osd = cur;
      }
    }
    if (osd != kNone) {
      o[placed] = osd;
      s[placed] = cur;
      ++placed;
      ++rep;
      ftotal = 0;
    } else if (++ftotal >= tries) {
      ++rep;
      ftotal = 0;
    }
  }
};

// indep: a pass is the lane's next unfilled (ftotal, slot), the slots of a
// round in order; a slot still kUndef at the end is a hole
struct Indep : Rule {
  using Rule::Rule;

  __device__ __forceinline__ void start(uint32_t x_, int* o_, int* s_) {
    lane(x_, o_, s_, kUndef);
    placed = numrep;            // slots left
  }
  __device__ __forceinline__ bool done() const { return placed == 0 || ftotal >= tries; }
  __device__ __forceinline__ void finish() const {
    for (int k = 0; k < numrep; ++k)
      if (o[k] == kUndef) o[k] = kNone;
  }

  __device__ __forceinline__ void pass() {
    const uint32_t r = static_cast<uint32_t>(rep + numrep * ftotal);
    const int cur = descend(m, levels, 0, x, r, ln);
    int osd = kNone;
    if (!taken(s, numrep, cur)) {
      if (leaf) {
        const int p = rep < positions - 1 ? rep : positions - 1;
        for (int ft = 0; ft < leaf_tries; ++ft) {
          const int cand = leaf_of(cur, p, static_cast<uint32_t>(rep) + r +
                                               static_cast<uint32_t>(numrep * ft));
          if (!is_out(osd_w, cand, x)) {
            osd = cand;
            break;
          }
        }
      } else if (!is_out(osd_w, cur, x)) {
        osd = cur;
      }
    }
    if (osd != kNone) {
      o[rep] = osd;
      s[rep] = cur;
      --placed;
    }
    // the next unfilled slot of this round, else the first of the next: a
    // scan of every slot, the same iterations for every thread
    int next = numrep, first = numrep;
    for (int k = numrep - 1; k >= 0; --k) {
      if (s[k] == kUndef) {
        first = k;
        if (k > rep) next = k;
      }
    }
    if (next < numrep) {
      rep = next;
    } else {
      rep = first;
      ++ftotal;
    }
  }
};

// One rule over the lanes lane, lane + stride, ... < n, one pass of the
// rule a loop iteration.  A thread whose lane is done takes its next lane at
// the top of a pass, so a warp's passes are its slowest thread's over all
// its lanes; the lane change has no exit inside it, so the warp reconverges
// there every pass.
template <class R>
__device__ __forceinline__ void drive(R rule, const int* xs, long long lane, long long stride,
                                      long long n, int* out, int* sel) {
  const int numrep = rule.numrep;
  bool live = false;
  for (lane -= stride;;) {
    if (!live || rule.done()) {
      if (live) rule.finish();
      lane += stride;
      live = lane < n;
      if (live)
        rule.start(static_cast<uint32_t>(xs[lane]), out + lane * numrep, sel + lane * numrep);
    }
    if (!live) break;
    rule.pass();
  }
}

// every lane's rule on map `m` (kernel_map_words, in shared memory when the
// block staged it)
__device__ __forceinline__ void map_lanes(const int* m, const int* xs, long long n, int numrep,
                                          const int* osd_w, const long long* ln, int* out,
                                          int* sel) {
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (m[5] <= 0) {                      // no tries: every slot a hole
    for (long long i = lane * numrep; i < n * numrep; i += stride * numrep)
      for (int k = 0; k < numrep; ++k) out[i + k] = kNone;
  } else if (m[3] != 0) {
    drive(Firstn(m, osd_w, ln, numrep), xs, lane, stride, n, out, sel);
  } else {
    drive(Indep(m, osd_w, ln, numrep), xs, lane, stride, n, out, sel);
  }
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
  // two instances: the staged map's reads are shared-memory loads
  if (staged)
    map_lanes(staged_map, xs, n, numrep, osd_w, ln, out, sel);
  else
    map_lanes(map, xs, n, numrep, osd_w, ln, out, sel);
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
