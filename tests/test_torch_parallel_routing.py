"""The mesh's routing (kernels K19 ``route_rows`` and K20
``routed_gather``, their plain versions on the CPU) against the
reference's shard_map programs on the conftest's 8 CPU devices:
sage2_tpu/parallel/sharded.py _route, _route_rows, _route_back and
_dedup_routed_gather, and the owner hashes _owner and _mix32. Exact
equality of dest, rank, sent_ok, the received rows in order, the
answers and the overflow flags, with and without overflow."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sage2_tpu.overlap.detect import _mix32
from sage2_tpu.parallel import make_mesh as ref_make_mesh
from sage2_tpu.parallel import sharded as ref
from sage2_tpu_torch.kernels import plain
from sage2_tpu_torch.parallel import comm, make_mesh, sharded
from torch_one_thread import one_thread  # noqa: F401

I32_MAX = 2**31 - 1
Q = 64          # inputs a shard


@functools.lru_cache(maxsize=None)
def _ref_mesh(n):
    return ref_make_mesh(n)


def _program(n, body, n_in, n_out):
    return jax.jit(shard_map(
        body, mesh=_ref_mesh(n), in_specs=(P("data"),) * n_in,
        out_specs=(P("data"),) * n_out, check_vma=False))


def _inputs(n, seed, hot=False):
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, n, size=n * Q).astype(np.int32)
    if hot:                 # most rows to one owner: a small cap overflows
        owner[rng.random(n * Q) < 0.7] = n - 1
    valid = rng.random(n * Q) < 0.8
    vals = rng.integers(0, 1 << 30, size=n * Q).astype(np.int32)
    return owner, valid, vals


def _per_shard(x, n):
    return [torch.from_numpy(np.ascontiguousarray(a))
            for a in np.asarray(x).reshape(n, -1, *np.asarray(x).shape[1:])]


def test_owner_hashes_match_reference():
    rng = np.random.default_rng(5)
    hi = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    hi[:4], lo[:4] = [0, 0xFFFFFFFF, 1 << 31, 7], [0, 0xFFFFFFFF, 5, 1 << 31]
    keys = (hi.astype(np.int64) << 32) | lo.astype(np.int64)
    u32 = lambda a: jnp.asarray(a.astype(np.uint32))  # noqa: E731
    for n in (1, 2, 3, 8):
        want = np.asarray(ref._owner(u32(hi), u32(lo), n))
        got = plain.owner_hash(torch.from_numpy(keys), n).numpy()
        np.testing.assert_array_equal(got, want)
        # a 32-base seed key is stored with its top bit flipped
        want = np.asarray(_mix32(u32(hi), u32(lo)) % np.uint32(n))
        flipped = torch.from_numpy(keys ^ np.int64(-2**63))
        got = plain.owner_hash(flipped, n, flip=True).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,cap,hot", [(8, 64, False), (8, 5, True),
                                       (2, 64, False), (2, 20, True)])
def test_route_matches_reference(n, cap, hot):
    """_route (values) and _route_back: dest, rank, sent_ok, received
    rows, overflow, and answers returned to the askers."""
    owner, valid, vals = _inputs(n, seed=n * 100 + cap, hot=hot)

    def body(o, v, x):
        r = ref._route("data", o, v, (x,), cap, n)
        ans = jnp.where(r.recv_valid, r.recv[0] * 3 + 1, 0)
        back = ref._route_back("data", ans, r)
        return (r.recv[0][None], r.recv_valid[None], r.dest, r.rank,
                r.sent_ok, r.overflow[None], back)

    out = _program(n, body, 3, 7)(jnp.asarray(owner), jnp.asarray(valid),
                                  jnp.asarray(vals))
    recv, recv_valid, dest, rank, sent_ok, ovf, back = map(np.asarray, out)
    mesh = make_mesh(n, devices="cpu")
    routes = [plain.route_rows(x[:, None], n, cap, owner=o, valid=v)
              for o, v, x in zip(_per_shard(owner, n), _per_shard(valid, n),
                                 _per_shard(vals, n))]
    for s, r in enumerate(routes):
        sl = slice(s * Q, (s + 1) * Q)
        np.testing.assert_array_equal(r.dest.numpy(), dest[sl])
        np.testing.assert_array_equal(r.rank.numpy(), rank[sl])
        np.testing.assert_array_equal(r.sent_ok.numpy(), sent_ok[sl])
        assert r.overflow == bool(ovf[s])
    assert any(r.overflow for r in routes) == hot
    got = sharded._exchange(mesh, routes)
    for d in range(n):
        np.testing.assert_array_equal(got[d][:, 0].numpy(),
                                      recv[d][recv_valid[d]])
    answers = [x * 3 + 1 for x in got]
    returned = sharded._answer(mesh, routes, answers)
    for s, r in enumerate(routes):
        np.testing.assert_array_equal(
            plain.route_back(returned[s], r.dest, r.rank, r.sent_ok,
                             r.offsets)[:, 0].numpy(),
            back[s * Q:(s + 1) * Q])


@pytest.mark.parametrize("n,cap,hot", [(8, 64, False), (8, 6, True)])
def test_route_rows_matches_reference(n, cap, hot):
    """_route_rows: (Q, K) rows in one exchange, received in order."""
    owner, valid, vals = _inputs(n, seed=7 + cap, hot=hot)
    rows = np.stack([vals, vals ^ 0x5555, np.arange(n * Q, dtype=np.int32)],
                    axis=1)

    def body(o, v, x):
        recv, ok, ovf = ref._route_rows("data", o, v, x, cap, n)
        return recv[None], ok[None], ovf[None]

    recv, recv_valid, ovf = map(np.asarray, _program(n, body, 3, 3)(
        jnp.asarray(owner), jnp.asarray(valid), jnp.asarray(rows)))
    mesh = make_mesh(n, devices="cpu")
    routes = [plain.route_rows(x, n, cap, owner=o, valid=v)
              for o, v, x in zip(_per_shard(owner, n), _per_shard(valid, n),
                                 _per_shard(rows, n))]
    assert [r.overflow for r in routes] == [bool(x) for x in ovf]
    assert any(r.overflow for r in routes) == hot
    got = sharded._exchange(mesh, routes)
    for d in range(n):
        np.testing.assert_array_equal(got[d].numpy(),
                                      recv[d][recv_valid[d]])


@pytest.mark.parametrize("n,cap,hot", [(1, 64, False), (1, 40, False),
                                       (3, 64, False), (3, 9, True),
                                       (4, 64, False), (4, 7, True),
                                       (8, 64, False), (8, 5, True)])
def test_one_way_route_matches_two_way_and_reference(n, cap, hot):
    """K19's one-way mode (``answers=False``, the exchanges whose answers
    do not come back): the same send buffer, counts, overflow and offsets
    as the two-way route, no dest/rank/sent_ok, and the rows the
    reference's _route_rows delivers, with hot owners and caps that cut
    (a single shard's cap below its valid rows too)."""
    owner, valid, vals = _inputs(n, seed=13 * n + cap, hot=hot)
    rows = np.stack([vals, vals ^ 0x3C3C, np.arange(n * Q, dtype=np.int32)],
                    axis=1)

    def body(o, v, x):
        recv, ok, ovf = ref._route_rows("data", o, v, x, cap, n)
        return recv[None], ok[None], ovf[None]

    recv, recv_valid, ovf = map(np.asarray, _program(n, body, 3, 3)(
        jnp.asarray(owner), jnp.asarray(valid), jnp.asarray(rows)))
    mesh = make_mesh(n, devices="cpu")
    shards = list(zip(_per_shard(owner, n), _per_shard(valid, n),
                      _per_shard(rows, n)))
    one = [plain.route_rows(x, n, cap, o, None, False, v, False)
           for o, v, x in shards]
    two = [plain.route_rows(x, n, cap, owner=o, valid=v)
           for o, v, x in shards]
    for a, b in zip(one, two):
        assert a.dest is None and a.rank is None and a.sent_ok is None
        assert b.dest is not None
        assert torch.equal(a.send, b.send)
        assert torch.equal(a.offsets, b.offsets)
        assert (a.counts, a.overflow) == (b.counts, b.overflow)
    assert [r.overflow for r in one] == [bool(x) for x in ovf]
    assert any(r.overflow for r in one) == (hot or (n == 1 and cap < Q))
    got = sharded._exchange(mesh, one)
    for d in range(n):
        np.testing.assert_array_equal(got[d].numpy(),
                                      recv[d][recv_valid[d]])


@pytest.mark.parametrize("n,cap", [(8, 64), (8, 2), (2, 64)])
def test_dedup_routed_gather_matches_reference(n, cap):
    """_dedup_routed_gather over two cyclic tables: repeated requests (a
    chain head asked by many), invalid ones, and a capacity that
    overflows."""
    rng = np.random.default_rng(n + cap)
    v_d = 16
    V = n * v_d
    t1 = rng.integers(-5, 1000, size=V).astype(np.int32)
    t2 = rng.integers(0, 1 << 20, size=V).astype(np.int32)
    idx = rng.integers(0, V, size=n * Q).astype(np.int32)
    idx[rng.random(n * Q) < 0.3] = 3          # a popular target
    valid = rng.random(n * Q) < 0.85
    # cyclic layout: vertex v on device v % n at slot v // n
    c1 = t1.reshape(v_d, n).T.reshape(-1)
    c2 = t2.reshape(v_d, n).T.reshape(-1)

    def body(a, b, i, v):
        out, ovf = ref._dedup_routed_gather("data", n, (a, b), i, v, cap)
        return out, ovf[None]

    out, ovf = map(np.asarray, _program(n, body, 4, 2)(
        jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(idx),
        jnp.asarray(valid)))
    mesh = make_mesh(n, devices="cpu")
    tables = list(zip(_per_shard(c1, n), _per_shard(c2, n)))
    comm.reset()
    with comm.label("test"):
        got, overflow = sharded._dedup_routed_gather(
            mesh, tables, _per_shard(idx, n), _per_shard(valid, n), cap)
    assert overflow == bool(ovf.any())
    assert overflow == (cap == 2)
    np.testing.assert_array_equal(torch.cat(got).numpy(), out)
    if not overflow:
        want = np.where(valid[:, None], np.stack([t1[idx], t2[idx]], 1), 0)
        np.testing.assert_array_equal(out, want)
    summary = comm.summary()["test"]
    assert summary["dispatches"] == 1
    assert summary["total_bytes"]["all_to_all"] > 0


def test_dedup_heads_cases():
    """K20's heads over sorted requests: runs, INT32_MAX tails, an input
    with no valid request."""
    for keys in ([3, 3, 5, 9, 9, 9, I32_MAX, I32_MAX], [I32_MAX] * 4,
                 [0], [1, 2, 3]):
        key = torch.tensor(keys, dtype=torch.int32)
        order = torch.randperm(len(keys), generator=torch.Generator()
                               .manual_seed(1))
        uniq, pos = plain.dedup_heads(key, order)
        s_key, s_ord = ref.sort_by_keys([jnp.asarray(keys, jnp.int32)],
                                        [jnp.asarray(order.numpy(),
                                                     jnp.int32)])
        prev = np.concatenate([[-1], np.asarray(s_key)[:-1]])
        is_head = (np.asarray(s_key) != prev) & (np.asarray(s_key) != I32_MAX)
        np.testing.assert_array_equal(
            uniq.numpy(), np.where(is_head, np.asarray(s_key), I32_MAX))
        head_pos = np.maximum.accumulate(
            np.where(is_head, np.arange(len(keys)), 0))
        want = np.zeros(len(keys), np.int32)
        want[order.numpy()] = head_pos
        np.testing.assert_array_equal(pos.numpy(), want)


def _ref_dedup_gather(n, c1, c2, idx, valid, cap):
    def body(a, b, i, v):
        out, ovf = ref._dedup_routed_gather("data", n, (a, b), i, v, cap)
        return out, ovf[None]

    out, ovf = map(np.asarray, _program(n, body, 4, 2)(
        jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(idx),
        jnp.asarray(valid)))
    return out, bool(ovf.any())


@pytest.mark.parametrize("requests", ["doubling", "shard_invalid"])
@pytest.mark.parametrize("n", [2, 4])
def test_dedup_routed_gather_skew_matches_reference(n, requests):
    """_dedup_routed_gather where pointer doubling leads it: most requests
    of a shard ask one chain head (long runs of equal sorted keys), and
    where one shard's requests are all invalid (its sorted keys all
    INT32_MAX)."""
    rng = np.random.default_rng(10 * n + len(requests))
    v_d = 16
    V = n * v_d
    t1 = rng.integers(-5, 1000, size=V).astype(np.int32)
    t2 = rng.integers(0, 1 << 20, size=V).astype(np.int32)
    idx = rng.integers(0, V, size=n * Q).astype(np.int32)
    valid = np.ones(n * Q, bool)
    if requests == "doubling":      # the late steps: a few chain heads
        idx[rng.random(n * Q) < 0.9] = 5
        idx[rng.random(n * Q) < 0.05] = V - 1
        valid[rng.random(n * Q) < 0.1] = False
    else:                           # shard 1 asks nothing
        valid[Q:2 * Q] = False
    c1 = t1.reshape(v_d, n).T.reshape(-1)
    c2 = t2.reshape(v_d, n).T.reshape(-1)
    out, ovf = _ref_dedup_gather(n, c1, c2, idx, valid, 64)
    mesh = make_mesh(n, devices="cpu")
    tables = list(zip(_per_shard(c1, n), _per_shard(c2, n)))
    got, overflow = sharded._dedup_routed_gather(
        mesh, tables, _per_shard(idx, n), _per_shard(valid, n), 64)
    assert not overflow and not ovf
    np.testing.assert_array_equal(torch.cat(got).numpy(), out)
    want = np.where(valid[:, None], np.stack([t1[idx], t2[idx]], 1), 0)
    np.testing.assert_array_equal(out, want)


def _heads_want(keys, order):
    """uniq and pos_of_orig of the reference's dedup (sharded.py:592-601)
    over the requests ``keys`` in sorted order and their input positions
    ``order``."""
    s_key, s_ord = ref.sort_by_keys([jnp.asarray(keys, jnp.int32)],
                                    [jnp.asarray(order, jnp.int32)])
    s_key = np.asarray(s_key)
    prev = np.concatenate([[-1], s_key[:-1]])
    is_head = (s_key != prev) & (s_key != I32_MAX)
    head_pos = np.maximum.accumulate(
        np.where(is_head, np.arange(len(keys)), 0))
    want = np.zeros(len(keys), np.int32)
    want[np.asarray(s_ord)] = head_pos
    return np.where(is_head, s_key, I32_MAX), want


@pytest.mark.parametrize("case", ["long_run", "tail_at_random",
                                  "runs_into_tail", "all_invalid_long"])
def test_dedup_heads_runs_and_tails(case):
    """K20's heads (its plain version here) where the kernel's tiles of
    1,024 sorted requests matter: a run of thousands of equal keys, an
    INT32_MAX tail that begins at an arbitrary position, a valid run that
    ends where the tail begins, thousands of invalid requests alone."""
    rng = np.random.default_rng(len(case))
    if case == "long_run":
        keys = np.concatenate([[0, 1], np.full(5000, 7), [8, 9, 9]])
    elif case == "tail_at_random":
        keys = np.sort(rng.integers(0, 300, size=4099))
        keys[int(rng.integers(1, 4099)):] = I32_MAX
    elif case == "runs_into_tail":
        keys = np.concatenate([np.arange(1500), np.full(3000, 1500),
                               np.full(2500, I32_MAX)])
    else:
        keys = np.full(4097, I32_MAX)
    keys = keys.astype(np.int32)
    order = rng.permutation(len(keys))
    uniq, pos = plain.dedup_heads(torch.from_numpy(keys),
                                  torch.from_numpy(order))
    want_uniq, want_pos = _heads_want(keys, order)
    np.testing.assert_array_equal(uniq.numpy(), want_uniq)
    np.testing.assert_array_equal(pos.numpy(), want_pos)


def test_make_mesh_maps_shards_to_devices():
    mesh = make_mesh(8, devices="cpu")
    assert mesh.size == 8 and mesh.axis_names == ("data",)
    assert {mesh.device_of(d) for d in range(8)} == {torch.device("cpu")}
    two = make_mesh(4, devices=["cpu", "meta"])
    assert [two.device_of(d).type for d in range(4)] == ["cpu", "meta"] * 2
    with pytest.raises(ValueError):
        make_mesh(2, axis_names=("a", "b"), devices="cpu")
    # K19 routes to at most 8 shards: a larger CUDA mesh is refused up
    # front (a CPU mesh runs the plain versions and takes any size)
    with pytest.raises(ValueError, match="at most 8"):
        make_mesh(9, devices="cuda")
    assert make_mesh(9, devices="cpu").size == 9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(2)


def test_comm_collectives_and_ledger():
    """psum, all_gather and ppermute over per-shard tensors, the ledger's
    bytes per label, and partition_vertex_range against the reference's
    host helper."""
    from sage2_tpu.parallel.sharded import partition_vertex_range as ref_pvr
    from sage2_tpu_torch.parallel import partition_vertex_range

    devices = [torch.device("cpu")] * 3
    xs = [torch.arange(4, dtype=torch.int32) + 10 * d for d in range(3)]
    comm.reset()
    with comm.label("stage"):
        assert torch.equal(comm.psum(xs), xs[0] + xs[1] + xs[2])
        assert comm.psum([1, 2, 3]) == 6
        gathered = comm.all_gather(xs, devices)
        moved = comm.ppermute(xs, [(0, 1), (1, 2), (2, 0)], devices)
    for g in gathered:
        assert torch.equal(g, torch.cat(xs))
    assert [torch.equal(m, xs[(d - 1) % 3]) for d, m in enumerate(moved)] \
        == [True] * 3
    with comm.label("stage"):
        comm.psum([5])
    s = comm.summary()["stage"]
    assert s["dispatches"] == 2
    assert s["total_bytes"] == {"psum": 3 * 16 + 3 * 8 + 8,
                                "all_gather": 3 * 48, "ppermute": 48}
    assert s["bytes_per_dispatch"]["psum"] == (3 * 16 + 3 * 8 + 8) // 2
    comm.reset()
    assert comm.summary() == {}
    values = np.arange(11, dtype=np.int32) * 3
    for nd in (1, 2, 4, 8):
        np.testing.assert_array_equal(partition_vertex_range(values, 11, nd),
                                      ref_pvr(values, 11, nd))
