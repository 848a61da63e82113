// General CRUSH for Hopper (sm_90a): kernel K6 ``crush_rule_lanes``.
//
// K5 (csrc/crush.cu) maps one rule over a uniform-depth hierarchy drawn as
// straw2 under jewel tunables.  Every other shape -- buckets that mix osds
// and buckets, a chooseleaf above the osds' parent, a plain choose of a
// bucket type, pre-jewel tunables (chooseleaf_stable 0, local retries),
// uniform, list, tree and legacy straw buckets, rules of several take or
// choose steps and choose steps with a replica count -- is mapped here.  The
// JAX package has no device kernel for these shapes: its table sweeps them on
// the host with the scalar engine (ceph_tpu/mon/pg_mapping.py:118-133), and
// this kernel runs that engine, crush_do_rule (ceph_tpu_torch/crush/
// mapper.py:426, mapper.c's decisions), on the card.
//
// One thread maps one lane (seed x): the whole rule, step by step, with
// mapper.c's working vectors (w, o, c; kMaxResult entries each, in local
// memory) and its choose functions -- _choose_firstn with local retries,
// local fallback retries, vary_r and stable, and _choose_indep with its
// uniform-bucket stride -- over a map flattened into int64 words in global
// memory (crush/rule_lanes.py flatten_rule):
//   header  {max_devices, bucket slots, slot table offset, steps, steps
//            offset, choose tries, local tries, local fallback tries,
//            descend once, vary_r, stable, total words}
//   slots   bucket id -> record offset (slot -1 - id; 0: no such bucket)
//   record  {id, type, alg, size, items offset, a, b, c}:
//             uniform  -
//             list     a: item weights offset, b: prefix sums offset
//             tree     a: node count, b: node weights offset
//             straw    a: straws offset (legacy straw values)
//             straw2   a: positions P, b: weights (P x size) offset,
//                      c: hash ids offset (choose_args ids, else the items)
//   steps   (op, arg1, arg2) each
// A straw bucket without legacy straw values is drawn by the scalar engine
// as straw2 on its own weights and ids; the flattener writes it so.
//
// The uniform bucket's permutation needs no state per lane.  mapper.c keeps
// one per bucket and builds its prefix lazily, but the prefix up to pr = r %
// size is a function of (x, bucket, pr) alone: step p swaps positions p and
// p + hash(x, id, p) % (size - p), and the r = 0 shortcut and its clean-up
// give the same first step.  So the entry at pr is found by walking the swaps
// back from p = pr to 0, from pr's position, rehashing each step.
//
// Bound on the H100: integer issue (rjenkins mixes, crush_ln, a 64-bit
// division per straw2 draw), not bytes: 4 bytes in and 4 * numrep out a
// lane.  This first kernel keeps the scalar engine's control flow as it is:
// the lanes of a warp diverge wherever their retries differ, and each straw2
// draw divides in 64 bits.
//
// Plain C interface for ctypes: the entry launches on the given device and
// stream, allocates nothing, and returns cudaGetLastError() (0 = launched).
//
// Without __CUDACC__ the kernel compiles as host C++ (no launcher, no C
// entry): the includer supplies threadIdx, blockIdx, blockDim, gridDim and
// __clz, and runs the threads itself.  A CPU test builds it that way.

#include <cstddef>
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kThreads = 128;
// the largest result_max (replicas a rule maps) the working vectors hold
constexpr int kMaxResult = 32;
constexpr int kNone = 0x7FFFFFFF;
constexpr int kUndef = 0x7FFFFFFE;
constexpr long long kS64Min = static_cast<long long>(1ull << 63);

enum Alg { kUniform = 1, kList = 2, kTree = 3, kStraw = 4, kStraw2 = 5 };
enum Op {
  kTake = 1, kChooseFirstn = 2, kChooseIndep = 3, kEmit = 4, kChooseleafFirstn = 6,
  kChooseleafIndep = 7, kSetChooseTries = 8, kSetChooseleafTries = 9,
  kSetChooseLocalTries = 10, kSetChooseLocalFallbackTries = 11, kSetChooseleafVaryR = 12,
  kSetChooseleafStable = 13
};
enum Header {
  hMaxDevices, hSlots, hSlotsOff, hSteps, hStepsOff, hChooseTries, hLocalTries,
  hLocalFallbackTries, hDescendOnce, hVaryR, hStable, hWords, kHeaderWords
};
enum Record { rId, rType, rAlg, rSize, rItems, rA, rB, rC, kRecordWords };

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a = a - b - c; a ^= c >> 13;
  b = b - c - a; b ^= a << 8;
  c = c - a - b; c ^= b >> 13;
  a = a - b - c; a ^= c >> 12;
  b = b - c - a; b ^= a << 16;
  c = c - a - b; c ^= b >> 5;
  a = a - b - c; a ^= c >> 3;
  b = b - c - a; b ^= a << 10;
  c = c - a - b; c ^= b >> 15;
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

__device__ __forceinline__ uint32_t hash32_4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  uint32_t h = kHashSeed ^ a ^ b ^ c ^ d, x = 231232, y = 1232;
  mix(a, b, h);
  mix(c, d, h);
  mix(a, x, h);
  mix(y, b, h);
  mix(c, x, h);
  mix(y, d, h);
  return h;
}

// 2^44 * log2(u + 1) in fixed point, u in [0, 0xffff] (mapper.c crush_ln)
__device__ __forceinline__ long long crush_ln(uint32_t u, const long long* ln) {
  uint32_t x = u + 1;                          // <= 0x10000
  int bits = __clz(static_cast<int>(x)) - 16;  // normalise below 0x8000
  bits = bits > 0 ? bits : 0;
  x <<= bits;
  const long long* pair = ln + 2 * ((x >> 8) - 128);
  // bits 48..55 of the unsigned product x * rh (it wraps for x = 0x10000)
  const unsigned long long xl =
      (static_cast<unsigned long long>(x) * static_cast<unsigned long long>(pair[0])) >> 48;
  return (static_cast<long long>(15 - bits) << 44) + ((pair[1] + ln[258 + (xl & 0xFF)]) >> 4);
}

// What a lane reads: the map words, the crush_ln tables, the 16.16
// reweights, and its seed.
struct Lane {
  const long long* m;
  const long long* ln;
  const int* osd_w;
  int n_w;
  uint32_t x;

  // the record of bucket `id`, or nullptr when the map has none
  __device__ __forceinline__ const long long* bucket(long long id) const {
    if (id >= 0) return nullptr;
    const long long slot = -1 - id;
    if (slot >= m[hSlots]) return nullptr;
    const long long off = m[m[hSlotsOff] + slot];
    return off ? m + off : nullptr;
  }
  __device__ __forceinline__ int item_type(int item) const {
    if (item >= 0) return 0;
    const long long* b = bucket(item);
    return b ? static_cast<int>(b[rType]) : -1;
  }
  __device__ __forceinline__ int item(const long long* b, long long i) const {
    return static_cast<int>(m[b[rItems] + i]);
  }
};

// mapper.c bucket_perm_choose: entry pr = r % size of the permutation that
// swaps p and p + hash(x, id, p) % (size - p) for p = 0, 1, ..., walked back
__device__ __forceinline__ int perm_choose(const Lane& L, const long long* b, uint32_t r) {
  const uint32_t size = static_cast<uint32_t>(b[rSize]);
  const uint32_t id = static_cast<uint32_t>(b[rId]);
  const uint32_t pr = r % size;
  uint32_t pos = pr;
  for (uint32_t p = pr + 1; p-- > 0;) {
    if (p + 1 < size) {
      const uint32_t i = hash32_3(L.x, id, p) % (size - p);
      if (i) {
        if (pos == p)
          pos = p + i;
        else if (pos == p + i)
          pos = p;
      }
    }
  }
  return L.item(b, pos);
}

__device__ __forceinline__ int list_choose(const Lane& L, const long long* b, uint32_t r) {
  const long long size = b[rSize];
  const long long* w = L.m + b[rA];
  const long long* sums = L.m + b[rB];
  const uint32_t id = static_cast<uint32_t>(b[rId]);
  for (long long i = size - 1; i >= 0; --i) {
    const int item = L.item(b, i);
    unsigned long long draw = hash32_4(L.x, static_cast<uint32_t>(item), r, id) & 0xFFFF;
    draw = (draw * static_cast<unsigned long long>(sums[i])) >> 16;
    if (static_cast<long long>(draw) < w[i]) return item;
  }
  return L.item(b, 0);
}

__device__ __forceinline__ int tree_choose(const Lane& L, const long long* b, uint32_t r) {
  const long long* nw = L.m + b[rB];
  const uint32_t id = static_cast<uint32_t>(b[rId]);
  long long n = b[rA] >> 1;
  while (!(n & 1)) {
    const unsigned long long w = static_cast<unsigned long long>(nw[n]);
    const unsigned long long h = hash32_4(L.x, static_cast<uint32_t>(n), r, id);
    // (h * w) >> 32 exactly, for a node weight of any width
    const unsigned long long t = h * (w >> 32) + ((h * (w & 0xFFFFFFFFull)) >> 32);
    int height = 0;
    while (!((n >> height) & 1)) ++height;
    const long long half = 1ll << (height - 1);
    n = t < static_cast<unsigned long long>(nw[n - half]) ? n - half : n + half;
  }
  return (n >> 1) < b[rSize] ? L.item(b, n >> 1) : kNone;
}

// legacy straw: the first largest (hash & 0xffff) * straw
__device__ __forceinline__ int straw_choose(const Lane& L, const long long* b, uint32_t r) {
  const long long size = b[rSize];
  const long long* straws = L.m + b[rA];
  long long high = 0;
  unsigned long long high_draw = 0;
  for (long long i = 0; i < size; ++i) {
    const unsigned long long draw =
        (hash32_3(L.x, static_cast<uint32_t>(L.item(b, i)), r) & 0xFFFF) *
        static_cast<unsigned long long>(straws[i]);
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return L.item(b, high);
}

// straw2: the first largest trunc((crush_ln(u) - 2^48) / w), S64_MIN for a
// weight 0, on the weight-set row of `position` (clipped to the last)
__device__ __forceinline__ int straw2_choose(const Lane& L, const long long* b, uint32_t r,
                                             int position) {
  const long long size = b[rSize];
  const long long rows = b[rA];
  const long long row = position < rows - 1 ? position : rows - 1;
  const long long* w = L.m + b[rB] + row * size;
  const long long* ids = L.m + b[rC];
  long long high = 0, high_draw = 0;
  for (long long i = 0; i < size; ++i) {
    long long draw = kS64Min;
    if (w[i]) {
      const uint32_t u = hash32_3(L.x, static_cast<uint32_t>(ids[i]), r) & 0xFFFF;
      draw = (crush_ln(u, L.ln) - 0x1000000000000ll) / w[i];
    }
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return L.item(b, high);
}

__device__ __forceinline__ int bucket_choose(const Lane& L, const long long* b, uint32_t r,
                                             int position) {
  switch (b[rAlg]) {
    case kUniform: return perm_choose(L, b, r);
    case kList: return list_choose(L, b, r);
    case kTree: return tree_choose(L, b, r);
    case kStraw: return straw_choose(L, b, r);
    case kStraw2: return straw2_choose(L, b, r, position);
    default: return L.item(b, 0);
  }
}

// mapper.c is_out: the 16.16 reweight rejects with probability 1 - w
__device__ __forceinline__ bool is_out(const Lane& L, int item) {
  if (item >= L.n_w) return true;
  const int w = L.osd_w[item];
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return static_cast<int>(hash32_2(L.x, static_cast<uint32_t>(item)) & 0xFFFF) >= w;
}

// mapper.c crush_choose_firstn (mapper.py _choose_firstn); kTop is the
// rule's own call, which may recurse to a leaf once
template <bool kTop>
__device__ int choose_firstn(const Lane& L, const long long* bucket, int numrep, int type,
                             int* out, int outpos, int out_size, int tries, int recurse_tries,
                             int local_retries, int local_fallback_retries,
                             bool recurse_to_leaf, int vary_r, int stable, int* out2,
                             uint32_t parent_r) {
  const int max_devices = static_cast<int>(L.m[hMaxDevices]);
  int count = out_size;
  for (int rep = stable ? 0 : outpos; rep < numrep && count > 0; ++rep) {
    int ftotal = 0;
    bool skip_rep = false;
    int item = 0;
    for (;;) {                                   // retry_descent
      bool retry_descent = false;
      const long long* in = bucket;
      int flocal = 0;
      for (;;) {                                 // retry_bucket
        bool retry_bucket = false, collide = false, reject = false;
        const uint32_t r = static_cast<uint32_t>(rep) + parent_r + static_cast<uint32_t>(ftotal);
        const long long size = in[rSize];
        if (size == 0) {
          reject = true;
        } else {
          if (local_fallback_retries > 0 && flocal >= (size >> 1) &&
              flocal > local_fallback_retries)
            item = perm_choose(L, in, r);
          else
            item = bucket_choose(L, in, r, outpos);
          if (item >= max_devices) {
            skip_rep = true;
            break;
          }
          const int itemtype = L.item_type(item);
          if (itemtype != type) {
            const long long* next = L.bucket(item);
            if (next == nullptr) {
              skip_rep = true;
              break;
            }
            in = next;
            continue;
          }
          for (int i = 0; i < outpos; ++i) {
            if (out[i] == item) {
              collide = true;
              break;
            }
          }
          reject = false;
          if constexpr (kTop) {
            if (!collide && recurse_to_leaf) {
              if (item < 0) {
                const int shift = vary_r - 1;
                const uint32_t sub_r = vary_r == 0 || shift >= 32 ? 0u : r >> shift;
                if (choose_firstn<false>(L, L.bucket(item), stable ? 1 : outpos + 1, 0, out2,
                                         outpos, count, recurse_tries, 0, local_retries,
                                         local_fallback_retries, false, vary_r, stable,
                                         nullptr, sub_r) <= outpos)
                  reject = true;
              } else {
                out2[outpos] = item;
              }
            }
          }
          if (!reject && !collide && itemtype == 0) reject = is_out(L, item);
        }
        if (reject || collide) {
          ++ftotal;
          ++flocal;
          if (collide && flocal <= local_retries)
            retry_bucket = true;
          else if (local_fallback_retries > 0 && flocal <= size + local_fallback_retries)
            retry_bucket = true;
          else if (ftotal < tries)
            retry_descent = true;
          else
            skip_rep = true;
        }
        if (!retry_bucket) break;
      }
      if (!retry_descent) break;
    }
    if (skip_rep) continue;
    out[outpos++] = item;
    --count;
  }
  return outpos;
}

// mapper.c crush_choose_indep (mapper.py _choose_indep)
template <bool kTop>
__device__ void choose_indep(const Lane& L, const long long* bucket, int left, int numrep,
                             int type, int* out, int outpos, int tries, int recurse_tries,
                             bool recurse_to_leaf, int* out2, uint32_t parent_r) {
  const int max_devices = static_cast<int>(L.m[hMaxDevices]);
  const int endpos = outpos + left;
  for (int rep = outpos; rep < endpos; ++rep) {
    out[rep] = kUndef;
    if (out2) out2[rep] = kUndef;
  }
  for (int ftotal = 0; left > 0 && ftotal < tries; ++ftotal) {
    for (int rep = outpos; rep < endpos; ++rep) {
      if (out[rep] != kUndef) continue;
      const long long* in = bucket;
      for (;;) {
        uint32_t r = static_cast<uint32_t>(rep) + parent_r;
        const long long size = in[rSize];
        if (in[rAlg] == kUniform && size % numrep == 0)
          r += static_cast<uint32_t>((numrep + 1) * ftotal);
        else
          r += static_cast<uint32_t>(numrep * ftotal);
        if (size == 0) break;
        const int item = bucket_choose(L, in, r, outpos);
        if (item >= max_devices) {
          out[rep] = kNone;
          if (out2) out2[rep] = kNone;
          --left;
          break;
        }
        const int itemtype = L.item_type(item);
        if (itemtype != type) {
          const long long* next = L.bucket(item);
          if (next == nullptr) {
            out[rep] = kNone;
            if (out2) out2[rep] = kNone;
            --left;
            break;
          }
          in = next;
          continue;
        }
        bool collide = false;
        for (int i = outpos; i < endpos; ++i) {
          if (out[i] == item) {
            collide = true;
            break;
          }
        }
        if (collide) break;
        if constexpr (kTop) {
          if (recurse_to_leaf) {
            if (item < 0) {
              choose_indep<false>(L, L.bucket(item), 1, numrep, 0, out2, rep, recurse_tries, 0,
                                  false, nullptr, r);
              if (out2 && out2[rep] == kNone) break;
            } else if (out2) {
              out2[rep] = item;
            }
          }
        }
        if (itemtype == 0 && is_out(L, item)) break;
        out[rep] = item;
        --left;
        break;
      }
    }
  }
  for (int rep = outpos; rep < endpos; ++rep) {
    if (out[rep] == kUndef) out[rep] = kNone;
    if (out2 && out2[rep] == kUndef) out2[rep] = kNone;
  }
}

// mapper.c crush_do_rule (mapper.py crush_do_rule) for one lane: its row of
// result_max items, CRUSH_ITEM_NONE past what the rule emits
__device__ void do_rule(const Lane& L, int result_max, int* result) {
  const long long* m = L.m;
  int w[kMaxResult], o[kMaxResult], c[kMaxResult];
  int wsize = 0, rlen = 0;
  int choose_tries = static_cast<int>(m[hChooseTries]);
  int choose_leaf_tries = 0;
  int local_retries = static_cast<int>(m[hLocalTries]);
  int local_fallback_retries = static_cast<int>(m[hLocalFallbackTries]);
  int vary_r = static_cast<int>(m[hVaryR]);
  int stable = static_cast<int>(m[hStable]);
  const long long* steps = m + m[hStepsOff];
  for (long long s = 0; s < m[hSteps]; ++s) {
    const int op = static_cast<int>(steps[3 * s]);
    const long long arg1 = steps[3 * s + 1];
    const int arg2 = static_cast<int>(steps[3 * s + 2]);
    switch (op) {
      case kTake:
        if ((arg1 >= 0 && arg1 < m[hMaxDevices]) || L.bucket(arg1) != nullptr) {
          w[0] = static_cast<int>(arg1);
          wsize = 1;
        }
        break;
      case kSetChooseTries:
        if (arg1 > 0) choose_tries = static_cast<int>(arg1);
        break;
      case kSetChooseleafTries:
        if (arg1 > 0) choose_leaf_tries = static_cast<int>(arg1);
        break;
      case kSetChooseLocalTries:
        if (arg1 >= 0) local_retries = static_cast<int>(arg1);
        break;
      case kSetChooseLocalFallbackTries:
        if (arg1 >= 0) local_fallback_retries = static_cast<int>(arg1);
        break;
      case kSetChooseleafVaryR:
        if (arg1 >= 0) vary_r = static_cast<int>(arg1);
        break;
      case kSetChooseleafStable:
        if (arg1 >= 0) stable = static_cast<int>(arg1);
        break;
      case kChooseFirstn:
      case kChooseIndep:
      case kChooseleafFirstn:
      case kChooseleafIndep: {
        if (wsize == 0) break;
        const bool firstn = op == kChooseFirstn || op == kChooseleafFirstn;
        const bool leaf = op == kChooseleafFirstn || op == kChooseleafIndep;
        int osize = 0;
        for (int i = 0; i < wsize; ++i) {
          long long numrep = arg1;
          if (numrep <= 0) {
            numrep += result_max;
            if (numrep <= 0) continue;
          }
          const long long* b = L.bucket(w[i]);
          if (b == nullptr) continue;
          if (firstn) {
            const int recurse_tries = choose_leaf_tries ? choose_leaf_tries
                                      : m[hDescendOnce] ? 1
                                                        : choose_tries;
            osize += choose_firstn<true>(L, b, static_cast<int>(numrep), arg2, o + osize, 0,
                                         result_max - osize, choose_tries, recurse_tries,
                                         local_retries, local_fallback_retries, leaf, vary_r,
                                         stable, c + osize, 0);
          } else {
            const int room = result_max - osize;
            const int out_size = numrep < room ? static_cast<int>(numrep) : room;
            choose_indep<true>(L, b, out_size, static_cast<int>(numrep), arg2, o + osize, 0,
                               choose_tries, choose_leaf_tries ? choose_leaf_tries : 1, leaf,
                               c + osize, 0);
            osize += out_size;
          }
        }
        for (int i = 0; i < osize; ++i) w[i] = leaf ? c[i] : o[i];
        wsize = osize;
        break;
      }
      case kEmit:
        for (int i = 0; i < wsize && rlen < result_max; ++i) result[rlen++] = w[i];
        wsize = 0;
        break;
      default:
        break;
    }
  }
  for (int k = rlen; k < result_max; ++k) result[k] = kNone;
}

// xs (n,) seeds; osd_w (n_w,) 16.16 reweights; map: flatten_rule's words;
// ln: RH_LH then LL; out (n, numrep).  Grid-stride over the lanes.
__global__ void __launch_bounds__(kThreads)
    crush_rule_lanes_kernel(const int* xs, long long n, int numrep, const int* osd_w, int n_w,
                            const long long* map, const long long* ln, int* out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; lane < n;
       lane += stride) {
    const Lane L{map, ln, osd_w, n_w, static_cast<uint32_t>(xs[lane])};
    do_rule(L, numrep, out + lane * numrep);
  }
}

}  // namespace

#ifdef __CUDACC__

extern "C" {

// xs (n,) int32 seeds; osd_w (n_w,) int32 reweights (may be null when n_w
// is 0); map (words,) int64 from flatten_rule; ln (514,) int64; out (n,
// numrep) int32.  All on `device`.  numrep <= crush_rule_max_result().
int crush_rule_lanes(const void* xs, long long n, int numrep, const void* osd_w, int n_w,
                     const void* map, const void* ln, void* out, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (n < 1 || numrep < 1 || numrep > kMaxResult || n_w < 0 || (n_w > 0 && osd_w == nullptr) ||
      xs == nullptr || map == nullptr || ln == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1ll << 20) ? want : (1ll << 20));
  crush_rule_lanes_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(xs), n, numrep, static_cast<const int*>(osd_w), n_w,
      static_cast<const long long*>(map), static_cast<const long long*>(ln),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

int crush_rule_max_result() { return kMaxResult; }

// info = {registers a thread, local memory bytes a thread, resident blocks
// a SM} as the CUDA runtime reports them for the kernel on `device`
int crush_rule_config(int device, int* info) {
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, crush_rule_lanes_kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, crush_rule_lanes_kernel, kThreads,
                                                      0);
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = blocks;
  return 0;
}

}  // extern "C"

#endif  // __CUDACC__
