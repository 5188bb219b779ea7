"""Parcat: concatenate independently encoded segment bitstreams.

Role of VTM:App/Parcat/parcat.cpp — the reference's only cross-machine
parallelism: encode closed-GOP segments on separate machines, concatenate
into one conformant stream (SURVEY.md §3.5).  Keeps the first segment's
parameter sets, renumbers slice POCs by the cumulative frame count (the
slice header's reference deltas are POC-relative, so they carry over
unchanged).
"""
from __future__ import annotations

from ..core import bitstream as bs
from ..spec import hls


def _count_frames(nals) -> int:
    return sum(1 for n in nals
               if n.nal_type in (bs.NAL_IDR_N_LP, bs.NAL_IDR_W_RADL,
                                 bs.NAL_TRAIL, bs.NAL_CRA))


def _renumber_slice(payload: bytes, poc_offset: int) -> bytes:
    r = bs.BitReader(payload)
    sh = hls.SliceHeader.read(r)
    rest = r.remaining_bytes()
    sh.poc += poc_offset
    sh.ref_pocs = tuple(rp + poc_offset for rp in sh.ref_pocs)
    w = sh.write()
    w.write_bytes(rest)
    return w.getvalue()


def parcat(streams: list[bytes]) -> bytes:
    """Concatenate Annex-B segment streams into one."""
    out_nals = []
    poc_offset = 0
    for si, data in enumerate(streams):
        nals = bs.read_annexb(data)
        for nal in nals:
            if nal.nal_type in (bs.NAL_SPS, bs.NAL_PPS, bs.NAL_VPS):
                if si == 0:
                    out_nals.append(nal)     # parameter-set dedup
                continue
            if nal.nal_type in (bs.NAL_IDR_N_LP, bs.NAL_IDR_W_RADL,
                                bs.NAL_TRAIL, bs.NAL_CRA):
                nal = bs.NalUnit(nal.nal_type,
                                 _renumber_slice(nal.payload, poc_offset),
                                 nal.layer_id, nal.temporal_id)
            out_nals.append(nal)
        poc_offset += _count_frames(nals)
    return bs.write_annexb(out_nals)
