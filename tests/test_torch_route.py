"""The port's routing layer against the JAX package, on the CPU.

Part A — in-process: the plain rank / scatter / reduce of
``repro_torch.kernels.route`` (what the CUDA wrappers run on a CPU
tensor) against the interpret-mode Pallas kernels and the XLA paths of
the reference, shard by shard, on the prime sizes of
``tests/test_route_kernels.py``; the wire bitcast and the virtual
all_to_all.

Part B — the reference's ``owner_route`` / ``owner_route_hier`` under
``shard_map`` on 8 fake host devices (one subprocess) against the
port's virtual shards: received streams and drop counts equal element
by element on 1/2/4/8 shards and 2x2/2x4 pods, with caps that drop.

The CUDA kernels against their plain versions: ``test_torch_kernels.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import routing as jrouting
from repro.kernels import route as jroute
from repro_torch.core import routing as trouting
from repro_torch.kernels import route as troute

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SIZES = [(1, 1), (7, 3), (61, 8), (127, 37), (509, 64)]   # (n, buckets)


def _tasks(seed, s, n, nb, k=2, d=2, p_valid=0.8):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, nb, (s, n)).astype(np.int32)
    valid = rng.random((s, n)) < p_valid
    x = rng.random((s, n, d)).astype(np.float32)
    aux = [rng.integers(-1, 1000, (s, n)).astype(np.int32) for _ in range(k)]
    return dest, valid, x, aux


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Part A
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,nb", SIZES)
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_matches_pallas_interpret(n, nb, seed):
    """bit-identical to ``bucket_rank_pallas`` everywhere (0 for invalid
    tasks), and on valid tasks to the one-hot / sort / XLA ranks."""
    dest, valid, _, _ = _tasks(seed, 3, n, nb)
    got = troute.plain_bucket_rank(_t(dest), _t(valid), nb).numpy()
    for s in range(3):
        want = np.asarray(jroute.bucket_rank_pallas(
            jnp.asarray(dest[s]), jnp.asarray(valid[s]), nb))
        assert np.array_equal(got[s], want)
        xla = np.asarray(jroute.bucket_rank_xla(jnp.asarray(dest[s]),
                                                jnp.asarray(valid[s]), nb))
        assert np.array_equal(got[s][valid[s]], xla[valid[s]])
    for impl in ("pallas", "sort", "onehot"):
        other = trouting.positions_by_dest(_t(dest), _t(valid), nb,
                                           impl=impl).numpy()
        assert np.array_equal(other[valid], got[valid]), impl


@pytest.mark.parametrize("n,nb", SIZES[1:])
@pytest.mark.parametrize("cap", [1, 3, 8])
def test_scatter_matches_pallas_and_xla(n, nb, cap):
    """(xb, ints, task_slot, n_drop) bit-identical to the fused Pallas
    kernel (interpret) and to the reference's XLA ``bucket``, for every
    port impl."""
    dest, valid, x, aux = _tasks(n * 31 + cap, 2, n, nb)
    ports = {impl: trouting.bucket(_t(x), _t(dest), _t(valid),
                                   [_t(a) for a in aux], nb, cap, impl=impl)
             for impl in ("pallas", "sort", "onehot")}
    for s in range(2):
        jargs = (jnp.asarray(x[s]), jnp.asarray(dest[s]),
                 jnp.asarray(valid[s]), [jnp.asarray(a[s]) for a in aux],
                 nb, cap)
        refs = {"fused": jroute.bucket_scatter_pallas(*jargs),
                "xla": jrouting.bucket(*jargs, impl="onehot")}
        for rname, want in refs.items():
            for impl, got in ports.items():
                tag = (rname, impl, s)
                assert np.array_equal(got[0][s].numpy(),
                                      np.asarray(want[0])), tag
                for a, b in zip(got[1], want[1]):
                    assert np.array_equal(a[s].numpy(), np.asarray(b)), tag
                assert np.array_equal(got[2][s].numpy(),
                                      np.asarray(want[2])), tag
                assert int(got[3][s]) == int(want[3]), tag


def test_scatter_one_d_payload_and_drops():
    dest, valid, x, aux = _tasks(5, 4, 211, 7, k=1, d=1)
    xt = _t(x[..., 0])
    for impl in ("pallas", "sort", "onehot"):
        xb, ints, slot, nd = trouting.bucket(xt, _t(dest), _t(valid),
                                             [_t(aux[0])], 7, 4, impl=impl)
        assert xb.shape == (4, 28) and ints[0].shape == (4, 28)
        assert int(nd.sum()) > 0
        kept = slot >= 0
        assert int(kept.sum() + nd.sum()) == int(valid.sum())


@pytest.mark.parametrize("op", ["min", "store", "add"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_matches_pallas_and_xla(op, seed):
    """min/store bit-identical to the Pallas kernel (interpret) and the
    XLA segment ops. add: both sum the same f32 values in another order,
    so they agree within 2 ulp of the slot's sum of |v| (exact here when
    the order coincides; the bound covers any order of <= 400 terms
    of magnitude <= 10)."""
    rng = np.random.default_rng(seed)
    s, n, m = 3, int(rng.integers(3, 400)), int(rng.integers(2, 60))
    slots = rng.integers(-1, m + 2, (s, n)).astype(np.int32)
    vals = (rng.random((s, n)) * 20 - 10).astype(np.float32)
    got = trouting.reduce_received(_t(slots), _t(vals), m, op).numpy()
    for r in range(s):
        js, jv = jnp.asarray(slots[r]), jnp.asarray(vals[r])
        # the reference's segment ops drop slots >= m; its kernel clips
        # them into a spare row: compare on the slots both define
        ok = slots[r] < m
        want_x = np.asarray(jrouting.reduce_received(js, jv, m, op))
        want_p = np.asarray(jroute.reduce_received_pallas(
            jnp.asarray(np.where(ok, slots[r], -1)), jv, m, op))
        scale = np.zeros(m, np.float32)
        np.add.at(scale, slots[r][(slots[r] >= 0) & ok],
                  np.abs(vals[r][(slots[r] >= 0) & ok]))
        for want in (want_x, want_p):
            if op == "add":
                assert np.all(np.abs(got[r] - want)
                              <= 2 * np.finfo(np.float32).eps * scale)
            else:
                assert np.array_equal(got[r], want)


@pytest.mark.parametrize("op", ["min", "store", "add"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_reduce_nan_matches_pallas_and_xla(op, sign):
    """A NaN of either sign in the stream: the plain version (what the
    CUDA kernels are held to on the card) gives what the Pallas kernel
    (interpret) and the XLA segment ops give: +inf under min and 0 under
    store where a slot received a NaN, before or after a finite value;
    NaN under add; untouched slots as usual."""
    nan = np.copysign(np.float32(np.nan), np.float32(sign))
    slots = np.array([0, 0, 1, 1, 2, 3, 3, -1, 4], np.int32)
    vals = np.array([nan, 5, 5, nan, -3, 7, 1, nan, nan], np.float32)
    assert bool(np.signbit(vals[0])) == (sign < 0)
    n_local = 6
    got = trouting.reduce_received(_t(slots)[None], _t(vals)[None], n_local,
                                   op)[0].numpy()
    want_x = np.asarray(jrouting.reduce_received(
        jnp.asarray(slots), jnp.asarray(vals), n_local, op))
    want_p = np.asarray(jroute.reduce_received_pallas(
        jnp.asarray(slots), jnp.asarray(vals), n_local, op))
    for want in (want_x, want_p):
        assert np.array_equal(got, want, equal_nan=True), (got, want)
    hit = {"min": np.inf, "store": 0.0, "add": np.nan}[op]
    assert np.array_equal(got[[0, 1, 4]], [hit] * 3, equal_nan=True)
    assert got[2] == -3.0 and got[5] == (np.inf if op == "min" else 0.0)


def test_empty_streams_are_safe():
    e_i = torch.zeros(2, 0, dtype=torch.int32)
    e_b = torch.zeros(2, 0, dtype=torch.bool)
    assert troute.bucket_rank(e_i, e_b, 4).shape == (2, 0)
    for impl in ("pallas", "sort", "onehot"):
        xb, ints, slot, nd = trouting.bucket(
            torch.zeros(2, 0, 1), e_i, e_b, [e_i], 4, 2, impl=impl)
        assert xb.shape == (2, 8, 1) and bool((xb == 0).all())
        assert bool((ints[0] == -1).all()) and slot.shape == (2, 0)
        assert nd.tolist() == [0, 0]
    for op, fill in (("add", 0.0), ("min", float("inf")), ("store", 0.0)):
        y = trouting.reduce_received(e_i, torch.zeros(2, 0), 5, op)
        want = jroute.reduce_received_pallas(jnp.zeros((0,), jnp.int32),
                                             jnp.zeros((0,)), 5, op)
        assert y.shape == (2, 5) and bool((y == fill).all())
        assert np.array_equal(y[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [None, 0, 1, 3])
def test_pack_wire_round_trip_is_bitwise(d):
    """-1 ints travel as a NaN bit pattern and come back as -1, next to
    the value columns, bit for bit as the reference packs them. ``d=0``
    is a squeezed [S, R] payload, ``None`` a wire of ints only."""
    rng = np.random.default_rng(7)
    vals = None if d is None else torch.from_numpy(rng.standard_normal(
        (2, 9, d) if d else (2, 9)).astype(np.float32))
    ints = [torch.from_numpy(rng.integers(-1, 5, (2, 9)).astype(np.int32)),
            torch.full((2, 9), -1, dtype=torch.int32)]
    packed, meta = trouting.pack_wire(vals, ints)
    assert packed.dtype == torch.float32
    assert packed.shape[-1] == (0 if d is None else max(d, 1)) + 2
    assert bool(torch.isnan(packed[..., -1]).all())
    v, got = trouting.unpack_wire(packed, meta)
    assert (v is None) if d is None else torch.equal(
        v.view(torch.int32), vals.view(torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(got, ints))
    jp, _ = jrouting.pack_wire(None if d is None else jnp.asarray(
        vals[0].numpy()), [jnp.asarray(i[0].numpy()) for i in ints])
    assert np.array_equal(packed[0].view(torch.int32).numpy(),
                          np.asarray(jp).view(np.int32))
    with pytest.raises(ValueError):
        trouting.pack_wire(None, [])
    with pytest.raises(TypeError):
        trouting.pack_wire(torch.zeros(2, 3, dtype=torch.float64), [])


@pytest.mark.parametrize("shape,dim", [((4,), 0), ((2, 3), 1), ((2, 3), 0),
                                       ((1, 4), 0), ((3, 1), 1)])
def test_noc_all_to_all_delivers_in_peer_order(shape, dim):
    """Shard g receives block g's coordinate of every peer along the
    axis, peers in order — ``lax.all_to_all(tiled=True)``'s layout."""
    s = int(np.prod(shape))
    b, rows = shape[dim], 2
    x = torch.arange(s * b * rows * 2, dtype=torch.float32).view(
        s, b * rows, 2)
    got = trouting.noc_all_to_all(x, shape, dim)
    coords = list(np.ndindex(*shape))
    for g, c in enumerate(coords):
        for p in range(b):
            peer = list(c)
            peer[dim] = p
            src = coords.index(tuple(peer))
            assert torch.equal(got[g, p * rows:(p + 1) * rows],
                               x[src, c[dim] * rows:(c[dim] + 1) * rows])


# ---------------------------------------------------------------------------
# Part B: owner_route / owner_route_hier streams vs shard_map
# ---------------------------------------------------------------------------

FLAT = (1, 2, 4, 8)
PODS = ((2, 2), (2, 4))
E_LOCAL, N_ITEMS, CAP = 64, 40, 8


def _route_inputs(seed, n_dev):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, N_ITEMS, E_LOCAL * n_dev).astype(np.int32)
    dest[rng.random(E_LOCAL * n_dev) < 0.15] = -1
    vals = rng.random(E_LOCAL * n_dev).astype(np.float32)
    return dest, vals


SCRIPT = r"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.core.compat import make_mesh, shard_map_unchecked
from repro.core.routing import owner_route, owner_route_hier
sys.path.insert(0, os.environ['TESTS_DIR'])
from test_torch_route import (CAP, FLAT, PODS, _route_inputs)

res = {}
def run(mesh, spec, axes, k, dest, vals):
    f = jax.jit(shard_map_unchecked(k, mesh=mesh, in_specs=(spec, spec),
                                    out_specs=(spec, spec, spec)))
    rs, rv, nd = f(jnp.asarray(dest), jnp.asarray(vals))
    return {'slot': np.asarray(rs).tolist(), 'val': np.asarray(rv).tolist(),
            'drop': np.asarray(nd).tolist()}

for n_dev in FLAT:
    dest, vals = _route_inputs(n_dev, n_dev)
    def k(d_b, v_b):
        valid = d_b >= 0
        d_c = jnp.maximum(d_b, 0)
        rs, rv, nd = owner_route(v_b, d_c // n_dev, d_c % n_dev, valid,
                                 n_dev, CAP, 'data', impl='pallas')
        return rs, rv, nd[None]
    res[f'flat{n_dev}'] = run(make_mesh((n_dev,), ('data',)), P('data'),
                              'data', k, dest, vals)
for n_pods, n_intra in PODS:
    n_dev = n_pods * n_intra
    dest, vals = _route_inputs(100 + n_dev, n_dev)
    def k(d_b, v_b):
        valid = d_b >= 0
        d_c = jnp.maximum(d_b, 0)
        rs, rv, nd = owner_route_hier(v_b, d_c // n_dev, d_c % n_dev, valid,
                                      n_intra, 'data', n_pods, 'pod', 4, 6,
                                      impl='pallas')
        return rs, rv, nd[None]
    res[f'pod{n_pods}x{n_intra}'] = run(
        make_mesh((n_pods, n_intra), ('pod', 'data')), P(('pod', 'data')),
        ('pod', 'data'), k, dest, vals)
print('RESULT ' + json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference_streams():
    env = dict(os.environ, PYTHONPATH=SRC,
               TESTS_DIR=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT ")][0]
    return json.loads(line[len("RESULT "):])


def _port_stream(case):
    if case.startswith("flat"):
        n_dev = int(case[4:])
        dest, vals = _route_inputs(n_dev, n_dev)
    else:
        n_pods, n_intra = (int(v) for v in case[3:].split("x"))
        n_dev = n_pods * n_intra
        dest, vals = _route_inputs(100 + n_dev, n_dev)
    dest, vals = _t(dest).view(n_dev, -1), _t(vals).view(n_dev, -1)
    valid, d_c = dest >= 0, dest.clamp(min=0)
    outs = {}
    for impl in ("pallas", "sort", "onehot"):
        if case.startswith("flat"):
            outs[impl] = trouting.owner_route(vals, d_c // n_dev, d_c % n_dev,
                                              valid, n_dev, CAP, impl=impl)
        else:
            outs[impl] = trouting.owner_route_hier(
                vals, d_c // n_dev, d_c % n_dev, valid, n_intra, n_pods, 4, 6,
                impl=impl)
    return outs


CASES = [f"flat{n}" for n in FLAT] + [f"pod{p}x{i}" for p, i in PODS]


@pytest.mark.parametrize("case", CASES)
def test_owner_route_streams_match_reference(reference_streams, case):
    want = reference_streams[case]
    n_dev = len(want["drop"])
    w_slot = np.asarray(want["slot"], np.int32).reshape(n_dev, -1)
    w_val = np.asarray(want["val"], np.float32).reshape(n_dev, -1)
    for impl, (rs, rv, nd) in _port_stream(case).items():
        assert np.array_equal(rs.numpy(), w_slot), impl
        assert np.array_equal(rv.numpy(), w_val), impl
        assert nd.tolist() == want["drop"], impl


def test_reference_streams_cover_drops(reference_streams):
    assert any(sum(c["drop"]) > 0 for c in reference_streams.values())
    assert set(reference_streams) == set(CASES)
