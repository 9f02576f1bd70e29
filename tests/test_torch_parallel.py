"""The sharded decode of defl_tpu_torch against defl_tpu.parallel, on the CPU.

The JAX package runs on the conftest's virtual 8-device CPU mesh; the port
runs ``DistributedCodec`` over eight CPU shards (``["cpu"] * 8``, decoded
in turn by the kernel's plain version; cards get a thread each), on the same
streams.  Each case of ``tests/test_dist.py`` (order, reduced stats, error
containment, dictionary broadcast, the 2-D mesh, an uneven batch, budget
exhaustion retried on the host) must give equal results, outputs and
stats: ``total_bytes``, ``ok_lanes``, ``shards`` and each lane's
``bitpos``.  Exact: a codec has no tolerance.

The process-group path runs here too: a gloo group of one rank in this
process, and ``dryrun_multichip(4)`` as two spawned gloo processes of two
CPU shards each (rank 1 is given no dictionary and must decode with rank
0's).  Nothing here needs the reference's native library: its host retry
falls back to its Python oracle without it.
"""

import zlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from defl_tpu.parallel.mesh import make_host_chip_mesh as ref_host_chip_mesh
from defl_tpu.parallel.mesh import make_stream_mesh as ref_stream_mesh
from defl_tpu.parallel.mesh import stream_sharding as ref_stream_sharding
from defl_tpu.parallel.shard import DistributedCodec as RefCodec
from defl_tpu_torch.errors import Result
from defl_tpu_torch.parallel import mesh as tmesh
from defl_tpu_torch.parallel import multihost
from defl_tpu_torch.parallel.shard import DistributedCodec
from tests.gendata import BitWriter, _fixed_lit_code, make_corpus

CORPUS = make_corpus()
CPU8 = ["cpu"] * 8
DICT = b"the broadcast dictionary shared by all shards " * 8


def _dict_streams(d, n=16):
    payloads = [b"the broadcast dictionary says stream %02d" % i
                for i in range(n)]
    streams = []
    for p in payloads:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=d)
        streams.append(co.compress(p) + co.flush())
    return payloads, streams


def _evil_stream():
    """Thousands of empty fixed blocks, then one literal: the device step
    budget runs out first (status RUNNING), the host retry finishes it."""
    w = BitWriter()
    for _ in range(3000):
        w.bits(0, 1).bits(1, 2)
        w.code(*_fixed_lit_code(256))
    w.bits(1, 1).bits(1, 2)
    w.code(*_fixed_lit_code(ord("Z")))
    w.code(*_fixed_lit_code(256))
    return w.getvalue()


# each case: (streams, flags, capacity, dictionary, 2-D mesh, the
# test_dist.py expectations on (results, outputs, stats))
def _case(name):
    if name == "order":
        pays = [bytes([i & 0xFF]) * (50 + 40 * i) for i in range(24)]
        return ([zlib.compress(p, 6) for p in pays], 1, 1024, None, False,
                lambda r, o, s: (all(x == 0 for x in r) and o == pays
                                 and s["total_bytes"] >= sum(map(len, pays))))
    if name == "stats":
        pays = [CORPUS["rand_64"]] * 16
        return ([zlib.compress(p) for p in pays], 1, 1024, None, False,
                lambda r, o, s: s["ok_lanes"] == 16
                and s["total_bytes"] == 16 * 64)
    if name == "errors":
        good = zlib.compress(CORPUS["text"][:500], 6)
        return ([good, b"\x07\x00\x00\x00"] * 8, 1, 1024, None, False,
                lambda r, o, s: r == [Result.OK, Result.ERR] * 8
                and o[::2] == [CORPUS["text"][:500]] * 8)
    if name == "dictionary":
        pays, streams = _dict_streams(DICT)
        return (streams, 1, 1024, DICT, False,
                lambda r, o, s: all(x == 0 for x in r) and o == pays)
    if name == "host_chip_2d":
        pays = [CORPUS["period_4"][:700]] * 8
        return ([zlib.compress(p) for p in pays], 1, 1024, None, True,
                lambda r, o, s: all(x == 0 for x in r) and o == pays)
    if name == "uneven":
        pays = [CORPUS["rand_255"]] * 11
        return ([zlib.compress(p) for p in pays], 1, 1024, None, False,
                lambda r, o, s: len(r) == 11 and all(x == 0 for x in r)
                and o == pays)
    if name == "budget":
        payload = b"normal stream " * 40
        streams = [zlib.compress(payload, 6)[2:-4] for _ in range(7)]
        return (streams + [_evil_stream()], 0, 4096, None, False,
                lambda r, o, s: r == [Result.OK] * 8
                and o == [payload] * 7 + [b"Z"])
    raise KeyError(name)


CASES = ("order", "stats", "errors", "dictionary", "host_chip_2d", "uneven",
         "budget")


def _assert_same(ref, port):
    (r0, o0, s0), (r1, o1, s1) = ref, port
    assert [int(x) for x in r1] == [int(x) for x in r0]
    assert o1 == o0
    for k in ("total_bytes", "ok_lanes", "shards"):
        assert int(s1[k]) == int(s0[k]), k
    np.testing.assert_array_equal(np.asarray(s1["bitpos"]),
                                  np.asarray(s0["bitpos"]))


@pytest.fixture(scope="module")
def ref_codec():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return RefCodec(ref_stream_mesh(), chunk_steps=128)


@pytest.fixture(scope="module")
def port_codec():
    return DistributedCodec(tmesh.make_stream_mesh(CPU8), chunk_steps=128)


@pytest.mark.parametrize("name", CASES)
def test_sharded_decode_equals_the_jax_package(name, ref_codec, port_codec):
    streams, flags, cap, d, two_d, expect = _case(name)
    if d is not None or two_d:
        ref_mesh = ref_host_chip_mesh() if two_d else ref_stream_mesh()
        port_mesh = (tmesh.make_host_chip_mesh(CPU8) if two_d
                     else tmesh.make_stream_mesh(CPU8))
        assert port_mesh.size == ref_mesh.devices.size == 8
        ref_codec = RefCodec(ref_mesh, dictionary=d, chunk_steps=128)
        port_codec = DistributedCodec(port_mesh, dictionary=d,
                                      chunk_steps=128)
    ref = ref_codec.inflate(streams, flags=flags, dst_capacities=cap)
    port = port_codec.inflate(streams, flags=flags, dst_capacities=cap)
    assert expect(*ref) and expect(*port)
    _assert_same(ref, port)
    assert port[2]["shards"] == 8
    # the CPU's plain version counts no launch of the kernel
    assert port[2]["decode_launches"] == 0
    if name == "budget":
        assert port[2]["host_fallbacks"] == [7]


@pytest.mark.parametrize("n", [1, 5, 8, 11, 24, 64])
def test_stream_sharding_is_the_jax_layout(n):
    """Each CPU shard's rows are the rows the JAX package places on the
    same position of the mesh (for the batch padded to a multiple of 8)."""
    n_pad = max(8, -(-n // 8) * 8)
    arr = jax.device_put(np.arange(n_pad), ref_stream_sharding(
        ref_stream_mesh()))
    by_dev = {s.device: s.index[0] for s in arr.addressable_shards}
    ref_rows = [by_dev[d] for d in ref_stream_mesh().devices.flat]
    port = tmesh.stream_sharding(tmesh.make_stream_mesh(CPU8), n_pad)
    assert [(sl.start, sl.stop) for _, sl in port] == \
        [(sl.start or 0, sl.stop or n_pad) for sl in ref_rows]
    # without padding, the port's shards hold the same rows up to n
    port = tmesh.stream_sharding(tmesh.make_stream_mesh(CPU8), n)
    assert [i for _, sl in port for i in range(sl.start, sl.stop)] == \
        list(range(n))


def test_host_chip_mesh_layout():
    m = tmesh.make_host_chip_mesh(["cpu"] * 4)
    assert m.axis_names == ("hosts", "chips")
    assert m.shape == {"hosts": 1, "chips": 4} and m.size == 4
    assert not m.grouped and m.world_size == 1 and m.rank == 0
    ref = ref_host_chip_mesh(jax.devices()[:4])
    assert tuple(ref.devices.shape) == (m.shape["hosts"], m.shape["chips"])


def test_default_mesh_is_the_cards_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tmesh.make_stream_mesh, tmesh.make_host_chip_mesh):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        with pytest.raises(RuntimeError, match="is_available"):
            make(["cuda:0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        DistributedCodec()
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.initialize("tcp://localhost:1", 1, 0)
    with pytest.raises(ValueError, match="unsupported"):
        tmesh.make_stream_mesh(["meta"])


def test_fewer_rows_than_shards_and_an_empty_batch(port_codec):
    pays = [b"only three rows " * 9, b"x", b""]
    streams = [zlib.compress(p) for p in pays]
    res, outs, st = port_codec.inflate(streams, dst_capacities=1024)
    assert [int(r) for r in res] == [0, 0, 0] and outs == pays
    assert st["ok_lanes"] == 3 and st["total_bytes"] == sum(map(len, pays))
    assert st["shards"] == 8 and len(st["bitpos"]) == 3
    res, outs, st = port_codec.inflate([], dst_capacities=1024)
    assert res == [] and outs == [] and st["ok_lanes"] == 0
    assert st["total_bytes"] == 0 and st["bitpos"].size == 0


def test_per_lane_capacities_and_undeclared_capacity():
    """A list of capacities goes row by row to the shards; with None each
    shard grows its own EFULL lanes on its device (≙ device_inflate)."""
    codec = DistributedCodec(tmesh.make_stream_mesh(["cpu"] * 3))
    pays = [bytes(range(256)) * k for k in (1, 2, 3, 40, 5, 6, 70)]
    streams = [zlib.compress(p, 6) for p in pays]
    caps = [len(p) for p in pays]
    caps[3] = 100
    res, outs, st = codec.inflate(streams, dst_capacities=caps)
    assert [int(r) for r in res] == [0, 0, 0, int(Result.EFULL), 0, 0, 0]
    assert outs[3] == pays[3][:100]
    res, outs, st = codec.inflate(streams, dst_capacities=None)
    assert [int(r) for r in res] == [0] * 7 and outs == pays
    with pytest.raises(ValueError, match="capacities"):
        codec.inflate(streams, dst_capacities=caps[:3])


@pytest.mark.parametrize("resolve", ["host", "device"])
def test_each_shard_equals_device_inflate(resolve):
    """Three CPU shards hand back what one device_inflate call gives for
    the same rows: the sharding adds nothing and drops nothing."""
    from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB
    from defl_tpu_torch.runtime.session import device_inflate

    rng = np.random.default_rng(3)
    pays = [rng.integers(0, 4, 300 + 37 * i, dtype=np.uint8).tobytes()
            for i in range(10)]
    streams = [zlib.compress(p, 6) for p in pays]
    streams[4] = streams[4][:-1] + bytes([streams[4][-1] ^ 1])
    flags = FLAG_ZLIB | FLAG_VERIFY_ADLER32
    codec = DistributedCodec(tmesh.make_stream_mesh(["cpu"] * 3),
                             resolve=resolve)
    res, outs, st = codec.inflate(streams, flags, dst_capacities=2048)
    r1, o1, s1 = device_inflate(streams, flags, dst_capacities=2048,
                                resolve=resolve, device="cpu")
    assert res == r1 and outs == o1 and res[4] is Result.ERR
    np.testing.assert_array_equal(st["bitpos"], s1["bitpos"])
    assert st["total_bytes"] == int(s1["dst_pos"].sum())
    assert st["ok_lanes"] == int((s1["status"] == 0).sum()) == 10


def test_shards_in_threads_keep_submission_order(monkeypatch):
    """The threaded path that cards of one process take, forced on three
    CPU shards: each shard's rows land in their place, the stats add up,
    and every thread finds its own device current."""
    from defl_tpu_torch.parallel import shard

    overlapped = shard._overlapped
    assert not overlapped([torch.device("cpu")] * 3)
    assert not overlapped([torch.device("cuda", 0)])
    assert overlapped([torch.device("cuda", 0), torch.device("cuda", 1)])
    monkeypatch.setattr(shard, "_overlapped", lambda devices: True)
    seen = []
    run = shard.session.device_inflate

    def spy(streams, *a, device=None, **k):
        import threading

        seen.append((threading.get_ident(), str(device)))
        return run(streams, *a, device=device, **k)

    monkeypatch.setattr(shard.session, "device_inflate", spy)
    pays = [bytes([65 + i]) * (40 + 30 * i) for i in range(7)]
    codec = DistributedCodec(tmesh.make_stream_mesh(["cpu"] * 3))
    res, outs, st = codec.inflate([zlib.compress(p) for p in pays],
                                  dst_capacities=1024)
    assert [int(r) for r in res] == [0] * 7 and outs == pays
    assert st["ok_lanes"] == 7 and st["total_bytes"] == sum(map(len, pays))
    assert len(seen) == 3 and len({t for t, _ in seen}) == 3


def test_resolve_is_checked():
    with pytest.raises(ValueError, match="resolve"):
        DistributedCodec(tmesh.make_stream_mesh(["cpu"]), resolve="tpu")


def test_local_stream_slice_without_a_group():
    assert not dist.is_initialized()
    assert multihost.local_stream_slice(10) == slice(0, 10)
    assert multihost.local_stream_slice(0) == slice(0, 0)


def test_gloo_group_of_one_in_process(tmp_path):
    """The process-group path in this process: a gloo group of one rank,
    a mesh made under it, the dictionary broadcast and the sums reduced
    on the CPU; then the group goes away."""
    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0,
                         device="cpu", timeout_s=60)
    try:
        assert dist.get_backend() == "gloo"
        codec = multihost.global_codec(DICT, devices=["cpu", "cpu"])
        assert codec.mesh.grouped and codec.mesh.shape == {"hosts": 1,
                                                           "chips": 2}
        pays, streams = _dict_streams(DICT, 6)
        res, outs, st = codec.inflate(streams, dst_capacities=1024)
        assert [int(r) for r in res] == [0] * 6 and outs == pays
        assert st["reduced_on"] == "cpu" and st["ok_lanes"] == 6
        assert st["total_bytes"] == sum(map(len, pays))
        assert multihost.local_stream_slice(6) == slice(0, 6)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_entry_decodes_its_batch():
    """dryrun.entry on the CPU: the forward step of the root
    ``__graft_entry__.entry`` (decode, then the resolve) on its 8 tiny
    streams; every lane OK, its bytes the payload's and zero past them.
    (The JAX entry run eagerly takes ~25 s here, so it is not run.)"""
    from defl_tpu_torch.dryrun import entry

    fn, args = entry("cpu")
    out, status, dst = fn(*args)
    pays = [bytes([i]) * (64 + 8 * i) for i in range(8)]
    assert status.tolist() == [0] * 8
    assert dst.tolist() == [len(p) for p in pays]
    assert [bytes(out[i, :len(p)].numpy()) for i, p in enumerate(pays)] \
        == pays
    assert out.shape == (8, 512) and not out[0, len(pays[0]):].any()


def test_dryrun_multichip_two_gloo_processes():
    """dryrun_multichip(4) on the CPU: 2 spawned gloo processes x 2 CPU
    shards, the (hosts, chips) = (2, 2) layout; rank 1 decodes with rank
    0's broadcast dictionary, each rank gets its host-major rows, the
    stats are the global sums; neither worker imported jax or
    defl_tpu."""
    from defl_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", timeout_s=120)
    assert out["mesh"] == {"hosts": 2, "chips": 2}
    assert out["backend"] == "gloo"
    assert [r["rows"] for r in out["ranks"]] == [[0, 4], [4, 8]]
    assert all(r["ok_lanes"] == 8 and r["reduced_on"] == "cpu"
               for r in out["ranks"])


def test_shared_device_workers_read_their_rows_from_a_file(tmp_path):
    """The workers the chip smoke run starts on one shared card, here on
    the CPU at a small size: each reads only its host-major rows of the
    batch from the parent's file, decodes them, and rank 1 decodes the
    dictionary streams with rank 0's dictionary."""
    from defl_tpu_torch import dryrun
    from defl_tpu_torch.corpus import make_silesia_like

    n, block = 8, 700
    pays = make_silesia_like(n * block, block)[:n]
    streams = [zlib.compress(p, 6) for p in pays]
    np.save(tmp_path / "lengths.npy", np.array(list(map(len, streams))))
    (tmp_path / "streams.bin").write_bytes(b"".join(streams))
    ranks = dryrun.run_workers(
        "shared_device_worker", 2, "gloo", ["cpu", "cpu"],
        dict(n_streams=n, block=block, device="cpu"),
        timeout_s=120, workdir=str(tmp_path))
    assert [r["rows"] for r in ranks] == [[0, 4], [4, 8]]
    assert [r["dict_rows"] for r in ranks] == [[0, 32], [32, 64]]
    for r in ranks:
        assert r["ok_lanes"] == n and r["total_bytes"] == sum(map(len, pays))
        assert r["dict_ok_lanes"] == 64 and r["host_fallbacks"] == 0
        assert r["reduced_on"] == "cpu" and r["launches"] == 0


def test_a_failed_worker_fails_the_run():
    """A worker that raises fails run_workers with its exit code and the
    end of its log; a peer still running then is killed, and no worker
    outlives the call."""
    import multiprocessing

    from defl_tpu_torch import dryrun

    with pytest.raises(RuntimeError, match=r"(?s)exit code 1\n.*"
                       r"ValueError: a mesh needs at least one device"):
        dryrun.run_workers("dryrun_worker", 2, "gloo", ["cpu", "cpu"],
                           dict(chips=0, device="cpu"), timeout_s=120)
    assert not multiprocessing.active_children()


def test_scaling_measurement_runs():
    """bench_scaling on the CPU's plain versions, with the JAX package's
    sanity bounds (tests/test_dist.py): correct, 8 shards not
    catastrophically slower than 1, and the sharding machinery adding no
    gross overhead over raw device_inflate.  CPU shards run one after
    another (the plain version costs the same per step whatever its lane
    count), so 2 of them are held to the JAX bound of 0.5 divided by 2;
    on the cards they overlap."""
    from defl_tpu_torch.bench_scaling import measure, measure_overhead

    m = measure(n_streams=4, block=700, reps=1, devices=["cpu"] * 2)
    assert m["scaling_n_devices"] == 2 and m["device"] == "cpu"
    assert m["shard1_s"] > 0 and m["shard2_s"] > 0
    assert m["shard2_speedup"] > 0.5 / 2, m
    o = measure_overhead(n_streams=2, block=700, reps=2, device="cpu")
    assert o["dist_overhead_pct"] < 60.0, o
    assert len(o["codec1_rounds_s"]) == len(o["raw_rounds_s"]) == 2

