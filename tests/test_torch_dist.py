"""Multi-device in the port (vvctpu_torch/dist: mesh, shard, gop) on the
CPU, its ranks spawned processes joined under gloo through a file://
rendezvous in tmp_path, every join under a timeout: test_shard.py's three
configs and test_tiles.py's 2x2 LMCS clip, without and with DQ, sharded
over a (1, 4) mesh, bytes
and recon equal (tolerance 0) to the one-rank port encode and to the spec
model, the sharded decode verifying the hashes and giving the recon, every
rank serving every sharded wave; the dryrun_multichip shape, a (2, 2) mesh
whose gop rows encode a segment each, against the unsharded
encode_gop_parallel (the port's and the reference's); a rank whose wave
fails fails every rank; test_gop_parallel.py's four cases; make_mesh and
init_distributed refusing too few ranks and nccl with more ranks on a host
than it has cards; the CLI's --distributed putting each process on its
card.

The rank functions import neither jax nor the JAX engine: each spawned
process imports this module."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from vvctpu.dist import gop as ref_gop  # noqa: E402
from vvctpu.spec import sequence as ref_seq  # noqa: E402
from vvctpu_torch.dist import gop as tgop  # noqa: E402
from vvctpu_torch.dist import mesh as dmesh  # noqa: E402
from vvctpu_torch.dist import shard  # noqa: E402
from vvctpu_torch.io.parcat import parcat  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

torch.set_num_threads(1)

# seconds a spawned group may take, its collectives' timeout included
_TIMEOUT = 240


# test_shard.py's three configs and test_tiles.py:55's 2x2 LMCS config
_CASES = {
    "inter_4x1": (lambda: chip_smoke.shard_frames(3, 128, 256),
                  dict(qp=32, intra_period=4, gop=2, tile_cols=4,
                       tile_rows=1)),
    "grid_2x2": (lambda: chip_smoke.shard_frames(2, 128, 128, seed=9),
                 dict(qp=37, intra_period=1, tile_cols=2, tile_rows=2)),
    # 2 tiles on a 4-rank tile axis: the unsharded wave
    "mismatch_falls_back": (lambda: chip_smoke.shard_frames(1, 64, 128,
                                                            seed=5),
                            dict(qp=32, intra_period=1, tile_cols=2)),
    # at 128 rows: at test_tiles.py's 64 the grid has one row of 2 tiles
    "lmcs_2x2": (lambda: chip_smoke.motion_frames(3, 128, 128, seed=83),
                 dict(qp=32, tile_cols=2, tile_rows=2, intra_period=0,
                      gop=2, mmvd=True, ciip=True, sbt=True, lmcs=True)),
    # the same with DQ: the trellis on every rank
    "lmcs_dq_2x2": (lambda: chip_smoke.motion_frames(3, 128, 128, seed=83),
                    dict(qp=32, tile_cols=2, tile_rows=2, intra_period=0,
                         gop=2, mmvd=True, ciip=True, sbt=True, lmcs=True,
                         dq=True)),
}


def _rank_tiles(frames, kw):
    """One rank of a (1, 4) mesh: the sharded encode, then the sharded
    decode of its stream with the hashes verified.  The controller returns
    (bytes, recon, decoded, waves sharded, per-rank stats); the others the
    number of waves they served."""
    torch.set_num_threads(1)
    mesh = dmesh.make_mesh(4, gop=1, device_type="cpu")
    cfg = tseq.EncoderConfig(**kw)
    with shard.use_mesh(mesh):
        if not shard.is_controller(mesh):
            return shard.serve(mesh)
        data, recons, _ = tenc.encode_sequence(frames, cfg, device="cpu")
        out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    return (data, recons, out, len(shard.stats["calls"]),
            shard.stats["ranks"])


def _ranks_beside(fn, frames, kw):
    """Four ranks running fn(frames, kw), started in a thread so that the
    test's own encodes run meanwhile; returns the future of their
    results."""
    ex = ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(dmesh.run_ranks, fn, 4, (frames, kw), timeout_s=_TIMEOUT)
    ex.shutdown(wait=False)
    return fut


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[c], y[c]) for x, y in zip(a, b) for c in range(3))


@pytest.mark.parametrize("case", list(_CASES))
def test_tile_sharded_equals_one_rank_and_spec_model(case):
    make, kw = _CASES[case]
    frames = make()
    ranks = _ranks_beside(_rank_tiles, frames, kw)
    one, one_rec, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(**kw), device="cpu")
    spec, _, _ = ref_seq.encode_sequence(frames, ref_seq.EncoderConfig(**kw))
    res = ranks.result()
    data, recons, out, calls, ranks = res[0]
    assert data == one == spec
    assert _same(recons, one_rec) and _same(out, recons)
    if case == "mismatch_falls_back":
        assert calls == 0 and res[1:] == [0, 0, 0]
        return
    # encode and decode: one sharded wave per group, every rank in each
    assert calls > 0 and res[1:] == [calls] * 3
    assert sorted(ranks) == [0, 1, 2, 3]
    assert all(s["batches"] > 0 for s in ranks.values())


def _rank_gop(frames, kw):
    """One rank of a (2, 2) mesh: encode_gop_parallel over it (each gop
    row a segment, its tiles over the row), then row 0 decodes the
    gathered stream over its tile axis with the hashes verified.  The
    row controllers return (bytes, recon, decoded or None)."""
    torch.set_num_threads(1)
    mesh = dmesh.make_mesh(4, device_type="cpu")
    assert mesh.shape == (2, 2)
    cfg = tseq.EncoderConfig(**kw)
    res = tgop.encode_gop_parallel(frames, cfg, mesh=mesh, device="cpu")
    out = None
    if mesh.get_coordinate()[0] == 0:
        out = shard.run(mesh["tile"], lambda d: tenc.decode_sequence(
            d, check_hash=True, device="cpu")[0], res and res[0])
    return None if res is None else (res[0], res[1], out)


def test_mesh_2x2_equals_unsharded_gop_parallel():
    """__graft_entry__.dryrun_multichip's shape over 4 ranks: the stream
    gathered over the gop axis equals the unsharded encode_gop_parallel
    (the port's and the reference's spec-model one)."""
    frames = chip_smoke.dryrun_frames(4, 64, 128)
    kw = dict(qp=34, intra_period=4, gop=2, tile_cols=2)
    ranks = _ranks_beside(_rank_gop, frames, kw)
    base, base_rec, _ = tgop.encode_gop_parallel(
        frames, tseq.EncoderConfig(**kw), segments=2, device="cpu")
    ref, _, _ = ref_gop.encode_gop_parallel(
        frames, ref_seq.EncoderConfig(**kw), segments=2)
    res = ranks.result()
    assert res[1] is None and res[3] is None
    (data, recons, out), (data2, _, none) = res[0], res[2]
    assert data == data2 == base == ref and none is None
    assert _same(recons, base_rec) and _same(out, recons)


def _rank_fails(frames, kw):
    """Rank 2's waves raise: every rank must fail, none hang."""
    torch.set_num_threads(1)
    mesh = dmesh.make_mesh(4, gop=1, device_type="cpu")
    if dmesh.dist.get_rank() == 2:
        from vvctpu_torch.pipeline import wave

        def broken(*a, **k):
            raise RuntimeError("injected wave failure")
        wave.frame_wave_batch = broken
    return shard.run(mesh, tenc.encode_sequence, frames,
                     tseq.EncoderConfig(**kw), device="cpu")


def test_failed_rank_fails_every_rank():
    make, kw = _CASES["grid_2x2"]
    with pytest.raises(RuntimeError, match="injected wave failure"):
        dmesh.run_ranks(_rank_fails, 4, args=(make()[:1], kw),
                        timeout_s=_TIMEOUT)


# test_gop_parallel.py's four cases


def test_segment_bounds_gop_aligned():
    assert tgop.segment_bounds(16, 2, 4) == [(0, 8), (8, 16)]
    assert tgop.segment_bounds(10, 3, 4) == [(0, 4), (4, 8), (8, 10)]
    assert tgop.segment_bounds(3, 8, 1) == [(0, 1), (1, 2), (2, 3)]
    for n in range(1, 20):
        for s in range(1, 6):
            for g in (1, 2, 4, 8):
                assert tgop.segment_bounds(n, s, g) == \
                    ref_gop.segment_bounds(n, s, g)


def test_equals_manual_parcat_and_decodes():
    frames = chip_smoke.motion_frames(6, 64, 96, seed=40)
    kw = dict(qp=32, intra_period=0, gop=2, mmvd=True)
    d1, _, _ = ref_seq.encode_sequence(frames[:4],
                                       ref_seq.EncoderConfig(**kw))
    d2, _, _ = ref_seq.encode_sequence(frames[4:],
                                       ref_seq.EncoderConfig(**kw))
    got, recons, bits = tgop.encode_gop_parallel(
        frames, tseq.EncoderConfig(**kw), segments=2, device="cpu")
    assert got == parcat([d1, d2])
    assert len(bits) == 6
    out, _ = tenc.decode_sequence(got, check_hash=True, device="cpu")
    assert _same(out, recons)


def test_threaded_matches_sequential():
    frames = chip_smoke.motion_frames(4, 64, 64, seed=41)
    cfg = tseq.EncoderConfig(qp=32)
    a, _, _ = tgop.encode_gop_parallel(frames, cfg, segments=2,
                                       threads=False, device="cpu")
    b, _, _ = tgop.encode_gop_parallel(frames, cfg, segments=2,
                                       threads=True, device="cpu")
    s, _, _ = tgop.encode_gop_parallel(frames, cfg, segments=2,
                                       engine="spec")
    assert a == b == s


def test_segment_for_process():
    assert tgop.segment_for_process(16, 2, 4, process_index=0) == (0, 8)
    assert tgop.segment_for_process(16, 2, 4, process_index=1) == (8, 16)
    # outside torch.distributed the process is rank 0
    assert tgop.segment_for_process(16, 2, 4) == (0, 8)


def test_too_few_ranks_and_nccl_sharing_a_card_raise(tmp_path):
    with pytest.raises(ValueError, match="need 4 ranks, have 1"):
        dmesh.make_mesh(4, gop=1, device_type="cpu")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="nccl needs a card per rank"):
        dmesh.init_distributed("file://" + str(tmp_path / "rv"),
                               max(cards + 1, 2),
                               0, backend="nccl", timeout_s=10)
    assert not dmesh.dist.is_initialized()


def _rank_nccl_hosts(cards):
    """nccl's check over the ranks' hosts, each rank seeing ``cards``
    cards (patched)."""
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: cards
    dmesh._check_nccl_hosts()
    return cards


def test_nccl_counts_ranks_per_host():
    """Two ranks on one host: refused on every rank with one card, let
    through with two (the ranks per host from their host names, not the
    world size)."""
    assert dmesh.run_ranks(_rank_nccl_hosts, 2, (2,),
                           timeout_s=_TIMEOUT) == [2, 2]
    with pytest.raises(RuntimeError) as e:
        dmesh.run_ranks(_rank_nccl_hosts, 2, (1,), timeout_s=_TIMEOUT)
    for r in (0, 1):
        assert f"rank {r} failed" in str(e.value)
    assert "nccl needs a card per rank: 2 ranks on host" in str(e.value)


def _rank_cli_device(frames):
    """The CLI's --distributed segment and device of this rank on a host
    with three cards (patched): without --device, then with LOCAL_RANK set
    to rank + 2, then with --device cpu.  Returns ([(device, suffix,
    segment)], the devices set current)."""
    import os
    from types import SimpleNamespace

    from vvctpu_torch import __main__ as cli
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 3
    current = []
    torch.cuda.set_device = current.append
    got = []
    for local, device in ((None, None), (2, None), (None, "cpu")):
        if local is not None:
            os.environ["LOCAL_RANK"] = str(dmesh.dist.get_rank() + local)
        args = SimpleNamespace(coordinator=None, num_processes=2,
                               process_id=None, device=device)
        seg, suffix = cli._segment(args, frames, 2)
        got.append((str(args.device), suffix, seg))
        os.environ.pop("LOCAL_RANK", None)
    return got, [str(d) for d in current]


def test_distributed_cli_puts_each_rank_on_its_card():
    got = dmesh.run_ranks(_rank_cli_device, 2, (list(range(8)),),
                          timeout_s=_TIMEOUT)
    assert got == [
        ([("cuda:0", ".seg0", [0, 1, 2, 3]), ("cuda:2", ".seg0", [0, 1, 2, 3]),
          ("cpu", ".seg0", [0, 1, 2, 3])], ["cuda:0", "cuda:2"]),
        ([("cuda:1", ".seg1", [4, 5, 6, 7]), ("cuda:0", ".seg1", [4, 5, 6, 7]),
          ("cpu", ".seg1", [4, 5, 6, 7])], ["cuda:1", "cuda:0"])]
