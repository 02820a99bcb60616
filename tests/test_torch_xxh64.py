"""The port's XXH64 against the xxhash package, and shard placement of both
packages over it.

``grape_vector_db_tpu_torch.utils.xxh64.xxh64_intdigest`` must return
``xxhash.xxh64_intdigest`` exactly, so a document id lands on the same shard
in either package: on 10,000 seeded ids of 0-40 bytes (ASCII, Latin-1,
CJK and astral characters), at every length around the 4-, 8- and 32-byte
steps of the algorithm, and on long inputs. ``ConsistentHashRing`` and
``ShardMap`` placements of both packages are equal for the same members and
configuration.
"""

import random

import pytest
import xxhash

from grape_vector_db_tpu.distributed import shard as jax_shard
from grape_vector_db_tpu_torch.distributed import shard as torch_shard
from grape_vector_db_tpu_torch.utils.xxh64 import xxh64_intdigest

_ALPHABETS = ["abcdefghijklmnopqrstuvwxyz0123456789-_",
              "".join(map(chr, range(0xA0, 0x180))),
              "漢字検索ベクトル데이터",
              "\U0001F600\U0001F680\U00010348"]


def _ids(n=10_000, seed=0):
    r = random.Random(seed)
    out = ["", "a", "doc-0", "é", "\U0001F600"]
    while len(out) < n:
        alphabet = r.choice(_ALPHABETS)
        s = "".join(r.choice(alphabet) for _ in range(r.randrange(0, 41)))
        # keep each id within 40 bytes of UTF-8, as the ids of the corpus are
        while len(s.encode()) > 40:
            s = s[:-1]
        out.append(s)
    return out


def test_seeded_ids_equal_xxhash():
    ids = _ids()
    assert max(len(i.encode()) for i in ids) == 40
    bad = [i for i in ids if xxh64_intdigest(i) != xxhash.xxh64_intdigest(i)]
    assert not bad, bad[:5]
    assert all(torch_shard.hash_key(i) == jax_shard.hash_key(i) for i in ids[:2000])


@pytest.mark.parametrize("n", list(range(0, 72)) + [255, 256, 1000, 4099])
def test_every_length_equals_xxhash(n):
    """Every tail of the 32-byte stripes, lanes, word and bytes, on one-byte
    characters of every value below 0x80 and on a repeated one."""
    for text in ("".join(chr((i * 37 + n) % 128) for i in range(n)), "x" * n):
        assert xxh64_intdigest(text) == xxhash.xxh64_intdigest(text)


def test_ring_placements_match_jax():
    ids = _ids(2000, seed=1)
    rings = []
    for mod in (torch_shard, jax_shard):
        ring = mod.ConsistentHashRing(virtual_nodes=100)
        for nid, w in (("node-1", 1.0), ("node-2", 2.0), ("node-3", 0.5)):
            ring.add_node(nid, weight=w)
        rings.append(ring)
    assert [rings[0].node_for(i) for i in ids] == [rings[1].node_for(i) for i in ids]
    for ring in rings:
        ring.remove_node("node-2")
    assert [rings[0].node_for(i) for i in ids] == [rings[1].node_for(i) for i in ids]


@pytest.mark.parametrize("algorithm", ["simple", "range", "consistent"])
@pytest.mark.parametrize("shards,replicas", [(16, 2), (8, 2), (7, 3)])
def test_shard_map_placements_match_jax(algorithm, shards, replicas):
    ids = _ids(3000, seed=2)
    maps = []
    for mod in (torch_shard, jax_shard):
        m = mod.ShardMap(shard_count=shards, replica_count=replicas, algorithm=algorithm)
        m.assign_all(["node-1", "node-2", "node-3"])
        maps.append(m)
    a, b = maps
    assert [a.shard_for_key(i) for i in ids] == [b.shard_for_key(i) for i in ids]
    assert {s: (i.primary_node, i.replica_nodes, i.range_start, i.range_end)
            for s, i in a.snapshot().items()} == {
        s: (i.primary_node, i.replica_nodes, i.range_start, i.range_end)
        for s, i in b.snapshot().items()}
    assert a.remove_node("node-2") == b.remove_node("node-2")
    assert [(i.primary_node, i.replica_nodes) for i in a.snapshot().values()] == [
        (i.primary_node, i.replica_nodes) for i in b.snapshot().values()]
