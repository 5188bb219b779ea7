"""Random access (hierarchical B): the port's bi_cost_pass, decide_frame_b,
bi-predicted phase A and frame-batched wave against the reference's, and
RA encodes byte-identical to the reference engine and the spec model,
cross-decoded both ways with hashes verified; exact integer equality."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.coding import decide as jdecide  # noqa: E402
from vvctpu.coding import me as jme  # noqa: E402
from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.pipeline import wave as jwave  # noqa: E402
from vvctpu.spec import codec as scodec  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu.spec.inter import REF_MARGIN  # noqa: E402
from vvctpu.spec.transform import lambda_rd_int  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.coding import decide as tdecide  # noqa: E402
from vvctpu_torch.coding import me as tme  # noqa: E402
from vvctpu_torch.core import bitstream as tbs  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402
from vvctpu_torch.spec import hls as thls  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_inter_parity import motion_frames  # noqa: E402
from test_wave_batch import synth  # noqa: E402

torch.set_num_threads(1)
H, W = 64, 96
QP = 32
LAM = 211


@functools.lru_cache(maxsize=None)
def _clip():
    """Five 64x96 frames with fresh noise per frame (so averaging two
    references pays and BI wins blocks), their padded luma planes and
    the REF_MARGIN-padded references POC 0 and POC 4."""
    frames = synth(5, H, W, seed=21)
    sps = sseq.EncoderConfig().make_sps(W, H)
    padded = [scodec.pad_planes(f, sps) for f in frames]
    refs = [np.pad(padded[i][0], REF_MARGIN, mode="edge") for i in (0, 4)]
    return sps, padded, refs


def _same(a, b):
    return all(np.array_equal(x[c], y[c]) for x, y in zip(a, b)
               for c in range(3))


@pytest.mark.parametrize("s", [8, 16, 32])
def test_bi_cost_pass(s):
    _, padded, (r0, r1) = _clip()
    rng = np.random.default_rng(s)
    # quarter-pel MVs in 1/16 pel, up to the ext stage's reach
    mv0 = rng.integers(-270, 271, (H // s, W // s, 2)).astype(np.int32) * 4
    mv1 = rng.integers(-270, 271, (H // s, W // s, 2)).astype(np.int32) * 4
    wc, ww = jme.bi_cost_pass(
        jnp.asarray(padded[2][0]), jnp.asarray(r0), jnp.asarray(r1),
        jnp.asarray(mv0), jnp.asarray(mv1), np.int32(LAM), s=s, frame_w=W,
        frame_h=H, planes0=jme.quarter_phase_planes(jnp.asarray(r0), 8),
        planes1=jme.quarter_phase_planes(jnp.asarray(r1), 8))
    gc, gw = tme.bi_cost_pass(
        torch.as_tensor(padded[2][0]), torch.as_tensor(mv0),
        torch.as_tensor(mv1), LAM, s=s, frame_w=W, frame_h=H,
        planes0=tme.quarter_phase_planes(torch.as_tensor(r0)),
        planes1=tme.quarter_phase_planes(torch.as_tensor(r1)))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))


def _decide_b(poc, me_ext):
    _, padded, (r0, r1) = _clip()
    want = jdecide.decide_frame_b(padded[poc][0], jnp.asarray(r0),
                                  jnp.asarray(r1), QP, 8, prepadded=True,
                                  me_ext=me_ext)
    got = tdecide.decide_frame_b(padded[poc][0], torch.as_tensor(r0),
                                 torch.as_tensor(r1), QP, 8, device="cpu",
                                 me_ext=me_ext)
    return got, want


@pytest.mark.parametrize("me_ext", [False, True])
def test_decide_frame_b_equal(me_ext):
    got, want = _decide_b(2, me_ext)
    want = state.decisions_from_numpy(want)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert got.equal(want)
    inter = got.inter8 > 0
    # intra, uni and BI leaves all occur
    assert (~inter).any()
    dirs = set(np.unique(got.dir8[inter]).tolist())
    assert 2 in dirs and len(dirs) > 1


def _kw(sps):
    return dict(frame_w=sps.width, frame_h=sps.height, qp=QP, bd=8,
                encode=True, rdoq=True, lam_rd=lambda_rd_int(QP))


def _tkw(sps):
    """_kw with the CTU size, which the port's wave takes from the SPS."""
    return dict(_kw(sps), log2_ctu=sps.log2_ctu)


def _b_frame_inputs(poc):
    """Slots, phase-A rows and the six reference planes of B frame
    ``poc`` (references: the padded source frames 0 and 4)."""
    sps, padded, _ = _clip()
    dec, _ = _decide_b(poc, True)
    slots, isl = trecon.make_slots_split(dec, sps.height, sps.width,
                                         1 << sps.log2_ctu)
    refs = [trecon.pad_refs_dev([torch.as_tensor(p) for p in padded[i]])
            for i in (0, 4)]
    return dec, slots, isl, refs[0] + refs[1]


def test_frame_wave_bi_leaves_equal_reference():
    sps, padded, _ = _clip()
    dec, slots, isl, trefs = _b_frame_inputs(2)
    assert (dec.dir8[dec.inter8 > 0] == 2).any()
    jslots, jisl = jrecon.make_slots_split(dec, sps.height, sps.width)
    np.testing.assert_array_equal(slots, jslots)
    jr = [jnp.asarray(r.numpy()) for r in trefs]
    want = jwave.frame_wave(jslots, *padded[2], inter_enabled=True,
                            ref_y=jr[0], ref_cb=jr[1], ref_cr=jr[2],
                            ref1_y=jr[3], ref1_cb=jr[4], ref1_cr=jr[5],
                            inter8=jisl[8], inter16=jisl[16],
                            inter32=jisl[32], **_kw(sps))
    got = twave.frame_wave(slots, *[torch.as_tensor(p) for p in padded[2]],
                           inter_enabled=True, refs=trefs, inter=isl,
                           **_tkw(sps))
    for i in range(6):          # recon y/cb/cr, levels y/cb/cr
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=f"output {i}")


@pytest.mark.parametrize("encode", [True, False])
def test_frame_wave_batch_equals_per_frame(encode):
    sps, padded, _ = _clip()
    kw = dict(_tkw(sps), encode=encode)
    frs, singles = [], []
    for poc in (1, 2, 3):
        _, slots, isl, refs = _b_frame_inputs(poc)
        planes = [torch.as_tensor(p) for p in padded[poc]]
        if not encode:          # decode from the per-frame encode's levels
            planes = list(twave.frame_wave(slots, *planes,
                                           inter_enabled=True, refs=refs,
                                           inter=isl, **_tkw(sps))[3:6])
        frs.append(dict(slots=slots, py=planes[0], pcb=planes[1],
                        pcr=planes[2], refs=refs, inter=isl))
        singles.append(twave.frame_wave(slots, *planes, inter_enabled=True,
                                        refs=refs, inter=isl, **kw))
    outs = twave.frame_wave_batch(frs, **kw)
    assert len(outs) == 3
    for got, want in zip(outs, singles):
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)
    # the merged schedule holds the leaves of every frame
    sched = twave.build_schedule_batch([fr["slots"] for fr in frs],
                                       sps.height, sps.width)
    n_rows = sum(r.shape[0] for _, r in sched)
    assert n_rows == sum(sum(r.shape[0] for _, r in
                             twave.build_schedule(fr["slots"], sps.height,
                                                  sps.width))
                         for fr in frs)


_CASES = {
    "gop4_64x96": (lambda: motion_frames(5),
                   dict(qp=32, intra_period=0, gop=4)),
    "gop8_64x128": (lambda: synth(9, 64, 128, seed=11),
                    dict(qp=33, intra_period=8, gop=8)),
}


@functools.lru_cache(maxsize=None)
def _port_encode(case):
    """(frames, the port's encode) of a case, shared by the tests of this
    module."""
    mk, kw = _CASES[case]
    frames = mk()
    return frames, tenc.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                        device="cpu")


@pytest.mark.parametrize("case", list(_CASES))
def test_ra_bytes_equal_reference_and_spec(case):
    """The port's bytes, bits and recon equal the reference engine's and
    the spec model's, and the port decodes the reference engine's stream
    with the hashes verified (the reference engine's encode is traced in
    this test alone: under xdist's load distribution the tests of this
    module may each run in a worker of their own)."""
    frames, (data, rec, bits) = _port_encode(case)
    jdata, jrec, jbits = jenc.encode_sequence(
        frames, sseq.EncoderConfig(**_CASES[case][1]))
    assert data == jdata
    assert bits == jbits
    assert _same(rec, jrec)
    sdata, srec, _ = tseq.encode_sequence(frames,
                                          tseq.EncoderConfig(**_CASES[case][1]))
    assert data == sdata
    assert _same(rec, srec)
    out, sps = tenc.decode_sequence(jdata, check_hash=True, device="cpu")
    assert _same(out, jrec)


@pytest.mark.parametrize("case", list(_CASES))
def test_ra_cross_decode(case):
    """The reference engine's decoder reads the port's stream with the
    hashes verified (the port's decoder reads the reference's in the
    test above), and the temporal ids follow the GOP plan."""
    _, (data, rec, _) = _port_encode(case)
    jout, _ = jenc.decode_sequence(data, check_hash=True)
    assert _same(jout, rec)
    # B pictures carry temporal ids max(qp_delta - 1, 1), I/P carry 0
    ip, gop = (_CASES[case][1][k] for k in ("intra_period", "gop"))
    want = [max(q - 1, 1) if t == thls.SLICE_B else 0
            for _, t, _, q in tseq.gop_plan(len(rec), ip, gop)]
    tids = [n.temporal_id for n in tbs.read_annexb(data)
            if n.nal_type in (tbs.NAL_IDR_N_LP, tbs.NAL_TRAIL)]
    assert tids == want and max(want) > 1


@pytest.mark.parametrize("tool", ["ibc_enabled", "plt_enabled"])
def test_b_stream_with_tool_outside_slice_raises(tool):
    """A random-access stream at CTU 128 whose SPS enables IBC or palette
    (which the spec model refuses at CTU 128) raises in the port's
    decoder (it is checked before any slice)."""
    frames = motion_frames(3)
    data, _, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(qp=32, intra_period=0, gop=2, ctu=128),
        device="cpu")
    nals = tbs.read_annexb(data)
    assert any(n.nal_type == tbs.NAL_TRAIL for n in nals)
    for i, n in enumerate(nals):
        if n.nal_type == tbs.NAL_SPS:
            sps = dataclasses.replace(thls.SPS.read(n.payload),
                                      **{tool: True})
            nals[i] = tbs.NalUnit(tbs.NAL_SPS, sps.write())
    with pytest.raises(ValueError, match="outside"):
        tenc.decode_sequence(tbs.write_annexb(nals), check_hash=True,
                             device="cpu")


@pytest.mark.parametrize("tool", ["tskip", "jccr"])
def test_b_stream_with_tool_now_in_slice_decodes(tool):
    """A random-access stream with transform skip or JCCR (outside the
    slice until they were ported) encodes the spec model's bytes
    (tolerance 0) and decodes in the port with the hashes verified."""
    frames = motion_frames(3)
    cfg = tseq.EncoderConfig(qp=32, intra_period=0, gop=2, **{tool: True})
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu")
    sdata, _, _ = tseq.encode_sequence(frames, cfg)
    assert data == sdata
    out, sps = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert sps.ts_enabled == (tool == "tskip")
    assert sps.jccr_enabled == (tool == "jccr")
    assert _same(out, rec)
