"""Wave reconstruction: the port's frame_wave against the reference's for
an I frame and a P frame (the reference picture carried across with
vvctpu_torch.state), recon and level planes exact; host tables equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.coding import decide as jdecide  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.pipeline import wave as jwave  # noqa: E402
from vvctpu.spec import codec as scodec  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu.spec.inter import REF_MARGIN  # noqa: E402
from vvctpu.spec.transform import lambda_rd_int  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402

from test_inter_parity import motion_frames  # noqa: E402

torch.set_num_threads(1)
QP = 32


def _setup():
    frames = motion_frames(n=2, h=64, w=128, seed=12)
    sps = sseq.EncoderConfig(qp=QP).make_sps(128, 64)
    padded = [scodec.pad_planes(f, sps) for f in frames]
    return sps, padded


def _kw(sps):
    return dict(frame_w=sps.width, frame_h=sps.height, qp=QP, bd=8,
                encode=True, rdoq=True, lam_rd=lambda_rd_int(QP))


def _t(p):
    return torch.as_tensor(np.array(p, np.int32))


def _compare(got, want):
    for i in range(6):          # recon y/cb/cr, levels y/cb/cr
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=f"output {i}")


def test_i_frame_recon_and_levels():
    sps, padded = _setup()
    dec = jdecide.decide_frame(padded[0][0], QP, 8)
    slots = jrecon.make_slots(dec, sps.height, sps.width)
    tdec = state.decisions_from_numpy(dec)
    tslots = trecon.make_slots(tdec, sps.height, sps.width)
    np.testing.assert_array_equal(tslots, slots)
    sched_j = jwave.build_schedule(slots, sps.height, sps.width)
    sched_t = twave.build_schedule(tslots, sps.height, sps.width)
    assert [c for c, _ in sched_t] == [c for c, _ in sched_j]
    for (_, a), (_, b) in zip(sched_t, sched_j):
        np.testing.assert_array_equal(a, b)
    want = jwave.frame_wave(slots, *padded[0], **_kw(sps))
    got = twave.frame_wave(tslots, *[_t(p) for p in padded[0]], **_kw(sps))
    _compare(got, want)
    # decoding from the levels rebuilds the same recon
    kw = dict(_kw(sps), encode=False)
    dec_out = twave.frame_wave(tslots, *got[3:6], **kw)
    for i in range(3):
        assert torch.equal(dec_out[i], got[i])


def test_p_frame_recon_and_levels():
    sps, padded = _setup()
    # reference picture: the reference engine's I-frame recon, padded on
    # its device, carried into the port as numpy
    dec0 = jdecide.decide_frame(padded[0][0], QP, 8)
    out0 = jwave.frame_wave(jrecon.make_slots(dec0, sps.height, sps.width),
                            *padded[0], **_kw(sps))
    jrefs = jrecon.pad_refs_dev(out0[:3])
    trefs = state.refs_from_numpy([np.asarray(r) for r in jrefs], "cpu")
    for a, b in zip(trecon.pad_refs_dev([_t(np.asarray(o)) for o in
                                         out0[:3]]), trefs):
        assert torch.equal(a, b)
    dec = jdecide.decide_frame_p(padded[1][0], jrefs[0], QP, 8,
                                 prepadded=True, me_ext=False)
    assert dec.inter8.any()
    slots, isl = jrecon.make_slots_split(dec, sps.height, sps.width)
    tslots, tisl = trecon.make_slots_split(state.decisions_from_numpy(dec),
                                           sps.height, sps.width)
    np.testing.assert_array_equal(tslots, slots)
    for s in (8, 16, 32):
        np.testing.assert_array_equal(tisl[s], isl[s])
    want = jwave.frame_wave(slots, *padded[1], inter_enabled=True,
                            ref_y=jrefs[0], ref_cb=jrefs[1],
                            ref_cr=jrefs[2], inter8=isl[8],
                            inter16=isl[16], inter32=isl[32], **_kw(sps))
    got = twave.frame_wave(tslots, *[_t(p) for p in padded[1]],
                           inter_enabled=True, refs=trefs, inter=tisl,
                           **_kw(sps))
    _compare(got, want)
    assert np.asarray(jrefs[0]).shape == (64 + 2 * REF_MARGIN,
                                          128 + 2 * REF_MARGIN)


def test_slab_strides():
    for h in (64, 1088):
        assert trecon._slab_strides(h) == jrecon._slab_strides(h)


def test_tables_from_numpy_matches_port_rom():
    from vvctpu.core import rom as jrom
    from vvctpu_torch.core import rom as trom
    names = {f"dct2_{n}": (jrom.DCT2, n) for n in (4, 8, 16, 32)}
    ref = {k: jrom.tr_matrix(*v) for k, v in names.items()}
    ref["mc_luma"] = jrom.mc_filter_luma()
    ref["mc_chroma"] = jrom.mc_filter_chroma()
    ref["intra_4tap"] = jrom.intra_filter_4tap(False)
    port = {k: trom.tr_matrix(*v) for k, v in names.items()}
    port["mc_luma"] = trom.mc_filter_luma()
    port["mc_chroma"] = trom.mc_filter_chroma()
    port["intra_4tap"] = trom.intra_filter_4tap(False)
    a, b = state.tables_from_numpy(ref), state.tables_from_numpy(port)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
