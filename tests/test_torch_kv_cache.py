"""The port's paged KV cache against the JAX package's, op for op.

Seeded random sequences of allocate, prefix match + register, copy-on-write,
fork, swap out, swap in and release go to both caches.  After every op the
two must agree exactly: the outcome (or the exception class), block tables,
refcounts, free lists, owners, the prefix index and its LRU order.  Both
pools start from the same random contents, so a swap round trip must give
back the same bytes in the same physical blocks on both sides (outside
the null block 0).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.serving import kv_cache as jkv

from repro_torch.serving import kv_cache as pkv

GEOM = dict(num_layers=2, num_kv_heads=2, head_dim=16, cache_len=64,
            block_size=4, num_blocks=24, dtype="float32")


def _state(c):
    a = c.allocator
    pfx = c.prefix
    return {
        "tables": {o: c.table_row(o).tolist() for o in c._tables},
        "refs": dict(a._refs), "free": list(a._free),
        "owned": {o: list(b) for o, b in a._owned.items()},
        "index": dict(pfx._index) if pfx else None,
        "lru": list(pfx._lru) if pfx else None,
        "evictions": pfx.evictions if pfx else None,
        "hits": pfx.hits if pfx else None,
        "swapped": {o: s.blocks for o, s in c._swapped.items()},
        "registered": dict(c._registered),
    }


def _call(cache, op, *args, **kw):
    try:
        out = getattr(cache, op)(*args, **kw)
    except (pkv.CacheOOM, jkv.CacheOOM):
        return "CacheOOM"
    except ValueError:
        return "ValueError"
    except IndexError:       # a write range past the owner's table
        return "IndexError"
    if isinstance(out, np.ndarray):
        return out.tolist()
    if isinstance(out, tuple):
        return tuple(x.tolist() if isinstance(x, np.ndarray) else x
                     for x in out)
    return out


def _pools(seed):
    rng = np.random.default_rng(seed)
    shape = (GEOM["num_layers"], GEOM["num_blocks"], GEOM["num_kv_heads"],
             GEOM["block_size"], GEOM["head_dim"])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("prefix", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_random_op_sequences_match_jax(seed, prefix):
    jc = jkv.PagedKVCache(prefix_cache=prefix, **GEOM)
    pc = pkv.PagedKVCache(prefix_cache=prefix, **GEOM)
    k, v = _pools(seed)
    jc.pool = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    pc.pool = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    rng = np.random.default_rng(seed)
    system = rng.integers(0, 50, 12)     # a shared prefix (3 full blocks)
    prompts = {}
    next_owner = 0
    for _ in range(120):
        live = sorted(o for o in prompts if o in pc._tables)
        swapped = sorted(pc._swapped)
        op = rng.choice(["alloc", "alloc", "register", "cow", "fork",
                         "swap_out", "swap_in", "release"])
        if op == "alloc":
            n = int(rng.integers(1, 30))
            toks = rng.integers(0, 50, n)
            if rng.random() < 0.5:
                toks[:min(n, 12)] = system[:min(n, 12)]
            owner = next_owner
            next_owner += 1
            prompts[owner] = toks
            total = n + int(rng.integers(0, 20))
            if prefix:
                args = ("allocate_prefix", owner, total, toks)
            else:
                args = ("allocate", owner, total)
        elif op == "register" and live and prefix:
            o = live[int(rng.integers(len(live)))]
            args = ("register_progress", o, prompts[o],
                    int(rng.integers(0, len(prompts[o]) + 1)))
        elif op == "cow" and live:
            o = live[int(rng.integers(len(live)))]
            args = ("ensure_private_range", o,
                    int(rng.integers(0, len(prompts[o]))),
                    int(rng.integers(1, 6)))
        elif op == "fork" and live:
            o = live[int(rng.integers(len(live)))]
            owner = next_owner
            next_owner += 1
            prompts[owner] = prompts[o]
            args = ("fork", o, owner)
            kw = {"shared_tokens": len(prompts[o])}
        elif op == "swap_out" and live:
            args = ("swap_out", live[int(rng.integers(len(live)))])
        elif op == "swap_in" and swapped:
            args = ("swap_in", swapped[int(rng.integers(len(swapped)))])
        elif op == "release" and (live or swapped):
            pool = live + swapped
            args = ("release", pool[int(rng.integers(len(pool)))])
        else:
            continue
        kw = kw if args[0] == "fork" else {}
        if args[0] == "ensure_private_range":
            # the engine copies each new private block's content
            jout = _call(jc, *args)
            pout = _call(pc, *args)
            if isinstance(pout, list):
                for _, src, dst in pout:
                    pc.copy_block(src, dst)
                    jc.pool = {n: a.at[:, dst].set(a[:, src])
                               for n, a in jc.pool.items()}
        else:
            jout = _call(jc, *args, **kw)
            pout = _call(pc, *args, **kw)
        assert pout == jout, (args, pout, jout)
        assert _state(pc) == _state(jc), args
    for name in ("k", "v"):   # block 0 is the null block: the JAX swap-in
        # pads its scatter with block-0 writes, the port's does not
        np.testing.assert_array_equal(pc.pool[name].numpy()[:, 1:],
                                      np.asarray(jc.pool[name])[:, 1:])


def test_swap_round_trip_restores_content():
    pc = pkv.PagedKVCache(prefix_cache=False, **GEOM)
    k, v = _pools(7)
    pc.pool = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    pc.allocate("a", 10)
    before = [pc.pool[n][:, pc._tables["a"]].clone() for n in ("k", "v")]
    pc.allocate("b", 6)
    assert pc.swap_out("a") == 3
    assert pc.is_swapped("a") and pc.swapped_blocks("a") == 3
    pc.pool["k"].zero_()                 # the freed blocks get overwritten
    pc.pool["v"].zero_()
    pc.release("b")
    pc.allocate("c", 8)                  # and reused by someone else
    pc.swap_in("a")
    after = [pc.pool[n][:, pc._tables["a"]] for n in ("k", "v")]
    for x, y in zip(before, after):
        assert torch.equal(x, y)
    assert not pc.is_swapped("a")


@pytest.mark.parametrize("block,hd,dtype", [
    (16, 128, "bfloat16"), (16, 16, "float32"), (3, 16, "float32"),
    (1, 8, "bfloat16"), (5, 4, "float32")])
def test_aligned_block_size_matches_jax(block, hd, dtype):
    assert pkv.aligned_block_size(block, hd, dtype) == \
        jkv.aligned_block_size(block, hd, jnp.dtype(dtype))
