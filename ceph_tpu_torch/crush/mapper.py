"""Scalar CRUSH rule engine (host oracle + control plane path).

Decision-for-decision rendering of src/crush/mapper.c: straw2 draws via the
fixed-point log (crush_ln), firstn's retry_descent/retry_bucket/reject flow
(mapper.c:441-617), indep's breadth-first stable placement
(mapper.c:636-825), and crush_do_rule_no_retry's step machine
(mapper.c:826-1032).  The bulk mapper (``crush/vectorized.py``: its plain
PyTorch version and kernel K5) is validated against this module lane by
lane, and this module serves the map shapes K5 does not take.
"""

from __future__ import annotations

from .hashes import crush_hash32_2, crush_hash32_3, crush_hash32_4
from .ln import crush_ln, S64_MIN
from .types import (
    Bucket,
    CrushMap,
    CRUSH_BUCKET_UNIFORM,
    CRUSH_BUCKET_LIST,
    CRUSH_BUCKET_TREE,
    CRUSH_BUCKET_STRAW,
    CRUSH_BUCKET_STRAW2,
    CRUSH_ITEM_NONE,
    CRUSH_ITEM_UNDEF,
    CRUSH_RULE_TAKE,
    CRUSH_RULE_CHOOSE_FIRSTN,
    CRUSH_RULE_CHOOSE_INDEP,
    CRUSH_RULE_EMIT,
    CRUSH_RULE_CHOOSELEAF_FIRSTN,
    CRUSH_RULE_CHOOSELEAF_INDEP,
    CRUSH_RULE_SET_CHOOSE_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES,
    CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES,
    CRUSH_RULE_SET_CHOOSELEAF_VARY_R,
    CRUSH_RULE_SET_CHOOSELEAF_STABLE,
)


class _WorkBucket:
    __slots__ = ("perm_x", "perm_n", "perm")

    def __init__(self, size: int) -> None:
        self.perm_x = 0
        self.perm_n = 0
        self.perm = [0] * size


class CrushWork:
    """Per-invocation scratch (uniform-bucket permutation state)."""

    def __init__(self, crush_map: CrushMap) -> None:
        self.work: dict[int, _WorkBucket] = {
            bid: _WorkBucket(b.size) for bid, b in crush_map.buckets.items()
        }


def _bucket_perm_choose(bucket: Bucket, work: _WorkBucket, x: int, r: int) -> int:
    pr = r % bucket.size
    if work.perm_x != (x & 0xFFFFFFFF) or work.perm_n == 0:
        work.perm_x = x & 0xFFFFFFFF
        if pr == 0:
            s = crush_hash32_3(x, bucket.id, 0) % bucket.size
            work.perm[0] = s
            work.perm_n = 0xFFFF  # magic: see cleanup branch
            return bucket.items[s]
        work.perm = list(range(bucket.size))
        work.perm_n = 0
    elif work.perm_n == 0xFFFF:
        # clean up after the r=0 fast path
        for i in range(1, bucket.size):
            work.perm[i] = i
        work.perm[work.perm[0]] = 0
        work.perm_n = 1
    while work.perm_n <= pr:
        p = work.perm_n
        if p < bucket.size - 1:
            i = crush_hash32_3(x, bucket.id, p) % (bucket.size - p)
            if i:
                work.perm[p + i], work.perm[p] = work.perm[p], work.perm[p + i]
        work.perm_n += 1
    return bucket.items[work.perm[pr]]


def _bucket_list_choose(bucket: Bucket, x: int, r: int) -> int:
    sums = bucket._list_sum_weights
    if sums is None:
        sums = []
        acc = 0
        for w in bucket.item_weights:
            acc += w
            sums.append(acc)
        # list buckets sum front-to-back in the reference builder; choice
        # walks back-to-front comparing against sum_weights[i]
        bucket._list_sum_weights = sums
    for i in range(bucket.size - 1, -1, -1):
        w = crush_hash32_4(x, bucket.items[i], r, bucket.id)
        w &= 0xFFFF
        w = (w * sums[i]) >> 16
        if w < bucket.item_weights[i]:
            return bucket.items[i]
    return bucket.items[0]


def _tree_height(n: int) -> int:
    h = 0
    while (n & 1) == 0:
        h += 1
        n >>= 1
    return h


def _bucket_tree_choose(bucket: Bucket, x: int, r: int) -> int:
    node_weights = bucket._tree_node_weights
    if node_weights is None:
        node_weights = _build_tree_weights(bucket)
        bucket._tree_node_weights = node_weights
    num_nodes = len(node_weights)
    n = num_nodes >> 1
    while not (n & 1):
        w = node_weights[n]
        t = (crush_hash32_4(x, n, r, bucket.id) * w) >> 32
        h = _tree_height(n)
        left = n - (1 << (h - 1))
        if t < node_weights[left]:
            n = left
        else:
            n = n + (1 << (h - 1))
    return bucket.items[n >> 1]


def _build_tree_weights(bucket: Bucket) -> list[int]:
    # leaves at odd indices 1,3,5,...; interior nodes accumulate children
    depth = 1
    while (1 << depth) < bucket.size * 2:
        depth += 1
    num_nodes = 1 << depth
    w = [0] * num_nodes
    for i, wt in enumerate(bucket.item_weights):
        node = i * 2 + 1
        w[node] = wt
        # propagate up
        d = 1
        while True:
            h = _tree_height(node) if node & 1 == 0 else 0
            parent = ((node >> (d)) | 1) << (d)
            if parent >= num_nodes:
                break
            w[parent] += wt
            if parent == num_nodes >> 1:
                break
            node2 = parent
            d = _tree_height(node2) + 1
            node = node2
    return w


def _bucket_straw_choose(bucket: Bucket, x: int, r: int) -> int:
    # legacy straw: requires precomputed straws; approximate with straw2
    # draws scaled by weights is NOT identical -- we compute the original
    # scheme only when straws are provided
    high = 0
    high_draw = -1
    straws = getattr(bucket, "straws", None)
    if straws is None:
        # fall back to straw2 semantics (modern maps don't use straw)
        return _bucket_straw2_choose(bucket, x, r)
    for i in range(bucket.size):
        draw = crush_hash32_3(x, bucket.items[i], r) & 0xFFFF
        draw *= straws[i]
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def _div64_s64(a: int, b: int) -> int:
    """C99 signed division (truncation toward zero)."""
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return q


def _generate_exponential_distribution(hash_type: int, x: int, y: int, z: int,
                                       weight: int) -> int:
    u = crush_hash32_3(x, y, z) & 0xFFFF
    ln = crush_ln(u) - 0x1000000000000
    return _div64_s64(ln, weight)


def _choose_arg_weights(bucket: Bucket, arg: dict | None,
                        position: int) -> list[int]:
    """mapper.c:289 get_choose_arg_weights: the per-position weight
    set (balancer override) or the bucket's own weights."""
    if not arg or not arg.get("weight_set"):
        return bucket.item_weights
    ws = arg["weight_set"]
    return ws[min(position, len(ws) - 1)]


def _bucket_straw2_choose(bucket: Bucket, x: int, r: int,
                          arg: dict | None = None,
                          position: int = 0) -> int:
    weights = _choose_arg_weights(bucket, arg, position)
    ids = (arg.get("ids") if arg else None) or bucket.items
    high = 0
    high_draw = 0
    for i in range(bucket.size):
        w = weights[i]
        if w:
            draw = _generate_exponential_distribution(
                bucket.hash, x, ids[i], r, w)
        else:
            draw = S64_MIN
        if i == 0 or draw > high_draw:
            high = i
            high_draw = draw
    return bucket.items[high]


def _crush_bucket_choose(bucket: Bucket, work: _WorkBucket, x: int, r: int,
                         arg: dict | None = None,
                         position: int = 0) -> int:
    if bucket.size == 0:
        raise AssertionError("empty bucket")
    if bucket.alg == CRUSH_BUCKET_UNIFORM:
        return _bucket_perm_choose(bucket, work, x, r)
    if bucket.alg == CRUSH_BUCKET_LIST:
        return _bucket_list_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_TREE:
        return _bucket_tree_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW:
        return _bucket_straw_choose(bucket, x, r)
    if bucket.alg == CRUSH_BUCKET_STRAW2:
        return _bucket_straw2_choose(bucket, x, r, arg, position)
    return bucket.items[0]


def _is_out(crush_map: CrushMap, weights: list[int], item: int, x: int) -> bool:
    if item >= len(weights):
        return True
    w = weights[item]
    if w >= 0x10000:
        return False
    if w == 0:
        return True
    return (crush_hash32_2(x, item) & 0xFFFF) >= w


def _choose_firstn(
    crush_map: CrushMap, work: CrushWork, bucket: Bucket,
    weights: list[int], x: int, numrep: int, choose_type: int,
    out: list[int], outpos: int, out_size: int,
    tries: int, recurse_tries: int, local_retries: int,
    local_fallback_retries: int, recurse_to_leaf: bool,
    vary_r: int, stable: int, out2: list[int] | None, parent_r: int,
    choose_args: dict | None = None,
) -> int:
    count = out_size
    rep = 0 if stable else outpos
    while rep < numrep and count > 0:
        ftotal = 0
        skip_rep = False
        item = 0
        while True:  # retry_descent
            retry_descent = False
            in_bucket = bucket
            flocal = 0
            while True:  # retry_bucket
                retry_bucket = False
                collide = False
                r = rep + parent_r + ftotal
                if in_bucket.size == 0:
                    reject = True
                else:
                    if (local_fallback_retries > 0
                            and flocal >= (in_bucket.size >> 1)
                            and flocal > local_fallback_retries):
                        item = _bucket_perm_choose(
                            in_bucket, work.work[in_bucket.id], x, r)
                    else:
                        item = _crush_bucket_choose(
                            in_bucket, work.work[in_bucket.id], x, r,
                            choose_args.get(in_bucket.id)
                            if choose_args else None, outpos)
                    if item >= crush_map.max_devices:
                        skip_rep = True
                        break
                    itemtype = crush_map.item_type(item)
                    if itemtype != choose_type:
                        if item >= 0 or item not in crush_map.buckets:
                            skip_rep = True
                            break
                        in_bucket = crush_map.buckets[item]
                        retry_bucket = True
                        continue
                    for i in range(outpos):
                        if out[i] == item:
                            collide = True
                            break
                    reject = False
                    if not collide and recurse_to_leaf:
                        if item < 0:
                            sub_r = r >> (vary_r - 1) if vary_r else 0
                            if _choose_firstn(
                                crush_map, work, crush_map.buckets[item],
                                weights, x, 1 if stable else outpos + 1, 0,
                                out2, outpos, count,
                                recurse_tries, 0, local_retries,
                                local_fallback_retries, False,
                                vary_r, stable, None, sub_r,
                                choose_args,
                            ) <= outpos:
                                reject = True
                        else:
                            out2[outpos] = item
                    if not reject and not collide:
                        if itemtype == 0:
                            reject = _is_out(crush_map, weights, item, x)
                if reject or collide:
                    ftotal += 1
                    flocal += 1
                    if collide and flocal <= local_retries:
                        retry_bucket = True
                    elif (local_fallback_retries > 0
                          and flocal <= in_bucket.size + local_fallback_retries):
                        retry_bucket = True
                    elif ftotal < tries:
                        retry_descent = True
                    else:
                        skip_rep = True
                if not retry_bucket:
                    break
            if not retry_descent:
                break
        if skip_rep:
            rep += 1
            continue
        out[outpos] = item
        outpos += 1
        count -= 1
        rep += 1
    return outpos


def _choose_indep(
    crush_map: CrushMap, work: CrushWork, bucket: Bucket,
    weights: list[int], x: int, left: int, numrep: int, choose_type: int,
    out: list[int], outpos: int, tries: int, recurse_tries: int,
    recurse_to_leaf: bool, out2: list[int] | None, parent_r: int,
    choose_args: dict | None = None,
) -> None:
    endpos = outpos + left
    for rep in range(outpos, endpos):
        out[rep] = CRUSH_ITEM_UNDEF
        if out2 is not None:
            out2[rep] = CRUSH_ITEM_UNDEF
    ftotal = 0
    while left > 0 and ftotal < tries:
        for rep in range(outpos, endpos):
            if out[rep] != CRUSH_ITEM_UNDEF:
                continue
            in_bucket = bucket
            while True:
                r = rep + parent_r
                if (in_bucket.alg == CRUSH_BUCKET_UNIFORM
                        and in_bucket.size % numrep == 0):
                    r += (numrep + 1) * ftotal
                else:
                    r += numrep * ftotal
                if in_bucket.size == 0:
                    break
                item = _crush_bucket_choose(
                    in_bucket, work.work[in_bucket.id], x, r,
                    choose_args.get(in_bucket.id)
                    if choose_args else None, outpos)
                if item >= crush_map.max_devices:
                    out[rep] = CRUSH_ITEM_NONE
                    if out2 is not None:
                        out2[rep] = CRUSH_ITEM_NONE
                    left -= 1
                    break
                itemtype = crush_map.item_type(item)
                if itemtype != choose_type:
                    if item >= 0 or item not in crush_map.buckets:
                        out[rep] = CRUSH_ITEM_NONE
                        if out2 is not None:
                            out2[rep] = CRUSH_ITEM_NONE
                        left -= 1
                        break
                    in_bucket = crush_map.buckets[item]
                    continue
                collide = False
                for i in range(outpos, endpos):
                    if out[i] == item:
                        collide = True
                        break
                if collide:
                    break
                if recurse_to_leaf:
                    if item < 0:
                        _choose_indep(
                            crush_map, work, crush_map.buckets[item],
                            weights, x, 1, numrep, 0,
                            out2, rep, recurse_tries, 0, False, None, r,
                            choose_args)
                        if out2 is not None and out2[rep] == CRUSH_ITEM_NONE:
                            break
                    elif out2 is not None:
                        out2[rep] = item
                if itemtype == 0 and _is_out(crush_map, weights, item, x):
                    break
                out[rep] = item
                left -= 1
                break
        ftotal += 1
    for rep in range(outpos, endpos):
        if out[rep] == CRUSH_ITEM_UNDEF:
            out[rep] = CRUSH_ITEM_NONE
        if out2 is not None and out2[rep] == CRUSH_ITEM_UNDEF:
            out2[rep] = CRUSH_ITEM_NONE


def crush_do_rule(
    crush_map: CrushMap, ruleno: int, x: int, result_max: int,
    weights: list[int], choose_args: dict | None = None,
) -> list[int]:
    """Run a rule; returns the mapped item vector (may contain NONE holes).

    ``choose_args`` (bucket id -> {"weight_set", "ids"}) overrides
    straw2 draw weights per output position -- the balancer's
    crush-compat weight-set mechanism (mapper.c crush_do_rule's
    choose_args parameter).  Defaults to the map's own choose_args."""
    if choose_args is None:
        choose_args = getattr(crush_map, "choose_args", None) or None
    rule = crush_map.rules.get(ruleno)
    if rule is None:
        return []
    t = crush_map.tunables
    work = CrushWork(crush_map)
    # "the original choose_total_tries value counted retries, not tries" --
    # add one (mapper.c:851-855)
    choose_tries = t.choose_total_tries + 1
    choose_leaf_tries = 0
    choose_local_retries = t.choose_local_tries
    choose_local_fallback_retries = t.choose_local_fallback_tries
    vary_r = t.chooseleaf_vary_r
    stable = t.chooseleaf_stable

    w: list[int] = []
    result: list[int] = []
    for step in rule.steps:
        if step.op == CRUSH_RULE_TAKE:
            if (0 <= step.arg1 < crush_map.max_devices
                    or step.arg1 in crush_map.buckets):
                w = [step.arg1]
        elif step.op == CRUSH_RULE_SET_CHOOSE_TRIES:
            if step.arg1 > 0:
                choose_tries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_TRIES:
            if step.arg1 > 0:
                choose_leaf_tries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSE_LOCAL_TRIES:
            if step.arg1 >= 0:
                choose_local_retries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSE_LOCAL_FALLBACK_TRIES:
            if step.arg1 >= 0:
                choose_local_fallback_retries = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_VARY_R:
            if step.arg1 >= 0:
                vary_r = step.arg1
        elif step.op == CRUSH_RULE_SET_CHOOSELEAF_STABLE:
            if step.arg1 >= 0:
                stable = step.arg1
        elif step.op in (CRUSH_RULE_CHOOSE_FIRSTN, CRUSH_RULE_CHOOSE_INDEP,
                         CRUSH_RULE_CHOOSELEAF_FIRSTN,
                         CRUSH_RULE_CHOOSELEAF_INDEP):
            if not w:
                continue
            firstn = step.op in (CRUSH_RULE_CHOOSE_FIRSTN,
                                 CRUSH_RULE_CHOOSELEAF_FIRSTN)
            recurse_to_leaf = step.op in (CRUSH_RULE_CHOOSELEAF_FIRSTN,
                                          CRUSH_RULE_CHOOSELEAF_INDEP)
            o = [0] * result_max
            c = [0] * result_max
            osize = 0
            for wi in w:
                numrep = step.arg1
                if numrep <= 0:
                    numrep += result_max
                    if numrep <= 0:
                        continue
                if wi >= 0 or wi not in crush_map.buckets:
                    continue
                bucket = crush_map.buckets[wi]
                # the reference passes o+osize / c+osize as segment bases:
                # collision scans and outpos are relative to this TAKE block
                seg = [0] * (result_max - osize)
                cseg = [0] * (result_max - osize)
                if firstn:
                    if choose_leaf_tries:
                        recurse_tries = choose_leaf_tries
                    elif t.chooseleaf_descend_once:
                        recurse_tries = 1
                    else:
                        recurse_tries = choose_tries
                    n = _choose_firstn(
                        crush_map, work, bucket, weights, x, numrep,
                        step.arg2,
                        seg, 0, result_max - osize,
                        choose_tries, recurse_tries,
                        choose_local_retries, choose_local_fallback_retries,
                        recurse_to_leaf, vary_r, stable, cseg, 0,
                        choose_args)
                    o[osize:osize + n] = seg[:n]
                    c[osize:osize + n] = cseg[:n]
                    osize += n
                else:
                    out_size = min(numrep, result_max - osize)
                    _choose_indep(
                        crush_map, work, bucket, weights, x, out_size,
                        numrep, step.arg2, seg, 0, choose_tries,
                        choose_leaf_tries if choose_leaf_tries else 1,
                        recurse_to_leaf, cseg, 0, choose_args)
                    o[osize:osize + out_size] = seg[:out_size]
                    c[osize:osize + out_size] = cseg[:out_size]
                    osize += out_size
            if recurse_to_leaf:
                o[:osize] = c[:osize]
            w = o[:osize]
        elif step.op == CRUSH_RULE_EMIT:
            for item in w:
                if len(result) < result_max:
                    result.append(item)
            w = []
    return result
