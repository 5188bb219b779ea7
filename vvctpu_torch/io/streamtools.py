"""Stream manipulation tools: SEI removal, sublayer extraction, layer merge.

Role of VTM:App/SEIRemovalApp, App/BitstreamExtractorApp and
App/StreamMergeApp (SURVEY.md §2.8): file-level operations over Annex-B
streams that never touch slice payloads.

- ``remove_sei``: strip SEI NAL units (optionally keeping the
  decoded-picture-hash suffix SEI, the self-check oracle).
- ``extract_sublayer``: temporal-sublayer extraction — drop every NAL with
  ``temporal_id`` above the target.  Valid because the hierarchical-B GOP
  (spec/sequence.py gop_plan) only references pictures at lower temporal
  layers, so the remaining stream is self-contained.
- ``merge_layers`` / ``extract_layer``: combine independently encoded
  streams into one multi-layer stream by ``nuh_layer_id`` and pull one
  layer back out as a plain (layer-0) stream.
"""
from __future__ import annotations

from ..core import bitstream as bs

_SEI_TYPES = (bs.NAL_PREFIX_SEI, bs.NAL_SUFFIX_SEI)
_SLICE_TYPES = (bs.NAL_TRAIL, bs.NAL_IDR_W_RADL, bs.NAL_IDR_N_LP,
                bs.NAL_CRA)
_PARAM_TYPES = (bs.NAL_VPS, bs.NAL_SPS, bs.NAL_PPS, bs.NAL_PREFIX_APS)


def remove_sei(data: bytes, keep_hash: bool = False) -> bytes:
    """Strip SEI NAL units (VTM:App/SEIRemovalApp role).

    keep_hash: keep suffix SEIs carrying the decoded-picture hash (they
    are this build's only suffix SEI payload)."""
    out = []
    for nal in bs.read_annexb(data):
        if nal.nal_type == bs.NAL_PREFIX_SEI:
            continue
        if nal.nal_type == bs.NAL_SUFFIX_SEI and not keep_hash:
            continue
        out.append(nal)
    return bs.write_annexb(out)


def extract_sublayer(data: bytes, max_tid: int) -> bytes:
    """Temporal-sublayer extraction (VTM:App/BitstreamExtractorApp role):
    keep parameter sets and every NAL with temporal_id <= max_tid."""
    out = []
    for nal in bs.read_annexb(data):
        if nal.nal_type in _PARAM_TYPES or nal.temporal_id <= max_tid:
            out.append(nal)
    return bs.write_annexb(out)


def merge_layers(streams: list[bytes]) -> bytes:
    """Merge independent streams into one multi-layer stream
    (VTM:App/StreamMergeApp role): stream k's NAL units get
    nuh_layer_id = k; access units are interleaved stream-major per
    picture so layers stay roughly aligned in decoding order."""
    per_layer = [bs.read_annexb(d) for d in streams]
    # split each layer's NAL list into "chunks" ending at a slice (+ its
    # trailing suffix SEIs), so interleaving keeps access units intact
    def chunks(nals):
        out, cur = [], []
        for i, n in enumerate(nals):
            cur.append(n)
            nxt = nals[i + 1].nal_type if i + 1 < len(nals) else None
            if n.nal_type in _SLICE_TYPES and nxt != bs.NAL_SUFFIX_SEI:
                out.append(cur)
                cur = []
            elif n.nal_type == bs.NAL_SUFFIX_SEI:
                out.append(cur)
                cur = []
        if cur:
            out.append(cur)
        return out

    layer_chunks = [chunks(nals) for nals in per_layer]
    out = []
    for i in range(max(len(c) for c in layer_chunks)):
        for lid, lc in enumerate(layer_chunks):
            if i < len(lc):
                for n in lc[i]:
                    out.append(bs.NalUnit(n.nal_type, n.payload, lid,
                                          n.temporal_id))
    return bs.write_annexb(out)


def extract_layer(data: bytes, layer_id: int) -> bytes:
    """Extract one layer of a merged stream as a plain layer-0 stream."""
    out = [bs.NalUnit(n.nal_type, n.payload, 0, n.temporal_id)
           for n in bs.read_annexb(data) if n.layer_id == layer_id]
    return bs.write_annexb(out)


SEI_SUBPIC_LAYOUT = 201      # project SEI: uniform subpicture grid


def _layout_sei_payload(cols: int, rows: int) -> bytes:
    return bytes((SEI_SUBPIC_LAYOUT, 2, cols, rows))


def subpic_layout(data: bytes):
    """(cols, rows) if the stream carries a subpicture-layout SEI, else
    None.  Only leading prefix SEIs are inspected (the layout SEI is
    written before any parameter set)."""
    for nal in bs.read_annexb(data):
        if nal.nal_type == bs.NAL_PREFIX_SEI and len(nal.payload) >= 4 \
                and nal.payload[0] == SEI_SUBPIC_LAYOUT:
            return int(nal.payload[2]), int(nal.payload[3])
        if nal.nal_type in _SLICE_TYPES:
            return None
    return None


def subpic_merge(streams: list[bytes], cols: int, rows: int) -> bytes:
    """Merge per-subpicture streams (subpic-raster order) into one stream:
    layer k carries subpicture k, announced by a layout SEI
    (VTM:App/SubpicMergeApp role; see dist/subpic.py)."""
    if len(streams) != cols * rows:
        raise ValueError("need cols*rows streams")
    merged = merge_layers(streams)
    head = bs.write_annexb([bs.NalUnit(bs.NAL_PREFIX_SEI,
                                       _layout_sei_payload(cols, rows))])
    return head + merged


def subpic_extract(data: bytes, k: int) -> bytes:
    """Extract subpicture k of a merged stream as a standalone conformant
    stream (VTM:App/BitstreamExtractorApp subpicture role): pure NAL
    filter — layer k minus the layout SEI."""
    out = []
    for n in bs.read_annexb(data):
        if (n.nal_type == bs.NAL_PREFIX_SEI and len(n.payload) >= 1
                and n.payload[0] == SEI_SUBPIC_LAYOUT):
            continue
        if n.layer_id == k:
            out.append(bs.NalUnit(n.nal_type, n.payload, 0, n.temporal_id))
    return bs.write_annexb(out)


_NAL_NAMES = {bs.NAL_TRAIL: "TRAIL", bs.NAL_IDR_W_RADL: "IDR_W_RADL",
              bs.NAL_IDR_N_LP: "IDR_N_LP", bs.NAL_CRA: "CRA",
              bs.NAL_VPS: "VPS", bs.NAL_SPS: "SPS", bs.NAL_PPS: "PPS",
              bs.NAL_PREFIX_APS: "PREFIX_APS", bs.NAL_PH: "PH",
              bs.NAL_PREFIX_SEI: "PREFIX_SEI",
              bs.NAL_SUFFIX_SEI: "SUFFIX_SEI"}


def stream_info(data: bytes) -> list[dict]:
    """Per-NAL summary rows (type, layer, tid, bytes) for the CLI."""
    rows = []
    for nal in bs.read_annexb(data):
        rows.append(dict(
            type=_NAL_NAMES.get(nal.nal_type, str(nal.nal_type)),
            layer=nal.layer_id, tid=nal.temporal_id,
            bytes=len(nal.payload)))
    return rows
